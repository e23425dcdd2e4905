"""The JAX side of the port's multi-rank train-step tests: the JAX
package's ``build_train_step(cfg, mesh)`` on a mesh of conftest's virtual
CPU devices, from the tiny preset at fp32 and 2 layers."""

import dataclasses

import jax
import numpy as np
from jax.sharding import Mesh

from pretraining_llm_tpu import config as jcfg
from pretraining_llm_tpu.training import train_step as jts

AXES = ("data", "fsdp", "tensor", "seq", "expert", "pipe")
LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=1e-3, atol=1e-4)
UPDATE_RTOL = 1e-2  # of the leaf's largest |update|
BATCH, SEQ = 8, 32


def tiny_config(**model):
    cfg = jcfg.get_preset("tiny")
    return cfg.replace(
        model=dataclasses.replace(cfg.model, **{"compute_dtype": "float32", "context_length": SEQ, "n_layers": 2,
                                                **model}),
        train=dataclasses.replace(cfg.train, batch_size=BATCH, train_steps=10))


def _flat(tree, prefix):
    return {"/".join((prefix,) + tuple(str(p.key) for p in path)): np.asarray(x)
            for path, x in jax.tree_util.tree_leaves_with_path(tree)}


def jax_run(cfg, sizes, steps=2, seed=0, final_state=None):
    """(initial params as a numpy tree, x, y, per-step metrics, the final
    params and optimizer state flattened by name: AdamW's moments,
    Adafactor's statistics or Muon's state). ``final_state`` (a list)
    receives the final state (the mesh's layout: baked for an interleaved
    pipeline)."""
    n = int(np.prod(sizes))
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(sizes), AXES)
    state = jts.init_train_state(cfg, jax.random.key(seed))
    params_np = jax.tree.map(np.asarray, jax.device_get(state["params"]))
    toks = np.random.default_rng(seed + 1).integers(0, cfg.model.vocab_size, (BATCH, SEQ + 1)).astype(np.int32)
    x, y = toks[:, :-1], toks[:, 1:]
    state = jts.shard_train_state(state, mesh, cfg)
    step = jts.build_train_step(cfg, mesh)
    metrics = []
    for _ in range(steps):
        state, m = step(state, (x, y))
        metrics.append({k: float(v) for k, v in m.items()})
    final = jax.device_get(state)
    if final_state is not None:
        final_state.append(final)
    flat = _flat(final["params"], "params")
    for k, sub in final["opt"].items():
        if k != "count":
            flat.update(_flat(sub, "opt/" + k))
    return params_np, x, y, metrics, flat


def check_against_jax(results, metrics, flat):
    """Every rank's metrics equal JAX's (loss rtol 1e-5); the ranks' blocks
    assemble to JAX's parameters and moments after the steps."""
    for r in results:
        for got, want in zip(r["metrics"], metrics):
            assert abs(got["loss"] - want["loss"]) <= LOSS_RTOL * abs(want["loss"]), (got, want)
            np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=1e-4)
            np.testing.assert_allclose(got["lr"], want["lr"], rtol=1e-6)
    for name, want in flat.items():
        np.testing.assert_allclose(_assemble(results, name, want.shape), want, err_msg=name, **PARAM_TOL)


def _assemble(results, name, shape):
    full = np.full(shape, np.nan, dtype=np.float32)
    for r in results:
        block, sl = r["blocks"][name]
        full[tuple(slice(a, b) for a, b in sl)] = block
    assert not np.isnan(full).any(), name
    return full


def check_updates(results, params_np, flat, cfg, interleave=1):
    """Each parameter's change over the steps (final - initial), assembled
    from the ranks' blocks, against JAX's within ``UPDATE_RTOL`` of the
    leaf's largest |change|: the steps' updates are a few lr in size, below
    ``PARAM_TOL``'s atol on the parameters themselves. ``interleave``: the
    state's blocks are in the baked layout of that many chunks a rank."""
    from pretraining_llm_tpu.parallel import pipeline as jpipe

    init = _flat(params_np, "params")
    for name, start in init.items():
        if interleave > 1 and name.startswith("params/blocks/"):
            start = np.asarray(jpipe.interleave_layout(start, cfg.model.pipeline_stages, interleave))
        want = flat[name] - start
        got = _assemble(results, name, want.shape) - start
        bar = UPDATE_RTOL * float(np.abs(want).max())
        assert bar > 0, name
        np.testing.assert_allclose(got, want, rtol=0, atol=bar, err_msg=name)
