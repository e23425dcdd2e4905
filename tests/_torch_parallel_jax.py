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
BATCH, SEQ = 8, 32


def tiny_config(**model):
    cfg = jcfg.get_preset("tiny")
    return cfg.replace(
        model=dataclasses.replace(cfg.model, compute_dtype="float32", context_length=SEQ, n_layers=2, **model),
        train=dataclasses.replace(cfg.train, batch_size=BATCH, train_steps=10))


def _flat(tree, prefix):
    return {"/".join((prefix,) + tuple(str(p.key) for p in path)): np.asarray(x)
            for path, x in jax.tree_util.tree_leaves_with_path(tree)}


def jax_run(cfg, sizes, steps=2, seed=0):
    """(initial params as a numpy tree, x, y, per-step metrics, the final
    params and AdamW moments flattened by name)."""
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
    flat = {**_flat(final["params"], "params"), **_flat(final["opt"]["mu"], "opt/mu"),
            **_flat(final["opt"]["nu"], "opt/nu")}
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
        full = np.full(want.shape, np.nan, dtype=np.float32)
        for r in results:
            block, sl = r["blocks"][name]
            full[tuple(slice(a, b) for a, b in sl)] = block
        assert not np.isnan(full).any(), name
        np.testing.assert_allclose(full, want, err_msg=name, **PARAM_TOL)
