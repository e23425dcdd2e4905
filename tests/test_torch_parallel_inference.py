"""The port's sharded inference on 4 gloo ranks at (fsdp 2, tensor 2)
against the JAX package (conftest's virtual CPU devices), from the tiny
preset at fp32 and 2 layers:

- ``shard_params_for_inference``: every rank's blocks equal the pieces of
  JAX's ``shard_params_for_inference`` on the device at the same mesh
  coordinates, bit for bit, for float trees and int8 trees with their
  ``_scale`` leaves (``test_quantize.py``'s sharded case); quantizing a
  rank's own float blocks gives the same int8 blocks and scales;
- ``generate(mesh=)``: greedy tokens equal to JAX's ``generate`` and to the
  port's world of one, on every rank (``test_generation.py``'s sharded
  decode case), ragged rows included;
- ``ServingEngine(mesh=)``: ``test_torch_parallel_serving.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from _torch_parallel_jax import AXES, tiny_config
from _torch_ranks import RankGroup
from _torch_threads import _one_torch_thread  # noqa: F401
from jax.sharding import Mesh

from pretraining_llm_tpu.generation.generate import generate as jgenerate
from pretraining_llm_tpu.generation.generate import shard_params_for_inference as jshard
from pretraining_llm_tpu.models import quantize as jquant
from pretraining_llm_tpu.models import transformer as jtf

SIZES = (1, 2, 2, 1, 1, 1)


@pytest.fixture(scope="module")
def ranks():
    group = RankGroup(4)
    yield group
    group.close()


def _params(cfg, seed=0):
    return jax.tree.map(np.asarray, jtf.init_params(cfg.model, jax.random.key(seed)))


def _flat(tree):
    return {"/".join(str(p.key) for p in path): leaf for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("quantize", [False, True], ids=["float", "int8"])
def test_shard_params_for_inference_matches_jax_pieces(ranks, quantize):
    cfg = tiny_config(pos_embed="rope", n_heads=8, n_kv_heads=4, tie_embeddings=False)
    params = _params(cfg)
    tree = jquant.quantize_params_for_serving(jax.tree.map(jnp.asarray, params), cfg.model) if quantize else params
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(SIZES), AXES)
    sharded = _flat(jshard(jax.tree.map(jnp.asarray, tree), mesh))
    results = ranks.run("_torch_parallel_cases:inference_blocks", cfg_dict=dataclasses.asdict(cfg),
                        params_np=params, sizes=SIZES, quantize=quantize)
    assert set(results[0]["blocks"]) == set(sharded)
    devices = jax.devices()[:4]
    for rank, r in enumerate(results):
        for name, arr in sharded.items():
            piece = next(s for s in arr.addressable_shards if s.device == devices[rank])
            np.testing.assert_array_equal(r["blocks"][name], np.asarray(piece.data), err_msg=name)
        if quantize:
            # The rank's own float blocks quantize to its blocks of the full
            # int8 tree, scales included (fsdp gathered: whole over fsdp).
            assert any(k.endswith("wo_scale") for k in r["local_quantized"])
            for name, want in r["local_full"].items():
                np.testing.assert_array_equal(r["local_quantized"][name], want, err_msg=name)


@pytest.mark.parametrize("model,ragged", [({}, False), (dict(pos_embed="rope", n_heads=6, n_kv_heads=3,
                                                              d_model=48), True)], ids=["mha", "gqa-g3-ragged"])
def test_generate_on_a_mesh_matches_jax(ranks, model, ragged):
    from pretraining_llm_tpu_torch.generation.generate import generate as tgen
    from pretraining_llm_tpu_torch.models import bridge

    cfg = tiny_config(**model)
    params = _params(cfg)
    prompt = np.random.default_rng(5).integers(0, cfg.model.vocab_size, (2, 12)).astype(np.int32)
    lengths = [12, 7] if ragged else None
    want = np.asarray(jgenerate(jax.tree.map(jnp.asarray, params), cfg.model, jnp.asarray(prompt), 5,
                                    jax.random.key(7), temperature=0.0, prompt_lengths=lengths))
    one = tgen(bridge.params_from_numpy(params, cfg.model, device="cpu"), cfg.model, prompt, 5, 7,
               temperature=0.0, prompt_lengths=lengths).numpy()
    np.testing.assert_array_equal(one, want)
    for got in ranks.run("_torch_parallel_cases:generate_on_mesh", cfg_dict=dataclasses.asdict(cfg),
                         params_np=params, prompt=prompt, n_new=5, sizes=SIZES, prompt_lengths=lengths):
        np.testing.assert_array_equal(got, want)
