"""The port's tensor axis on 4 gloo ranks against the JAX package's
``build_train_step(cfg, mesh)`` on the same mesh shape (conftest's virtual
CPU devices): (fsdp 2, tensor 2) and (data 2, tensor 2) over the tiny
preset at 2 layers, fp32, 2 AdamW steps, for the MHA model with learned
positions and a tied head (the grouped-KV and swiglu cases are in
``test_torch_parallel_tensor_gqa.py``). The bars
are ``test_torch_parallel_train.py``'s: loss rtol 1e-5 per step, grad norm
rtol 1e-4, the parameters and AdamW's moments assembled from the ranks'
blocks rtol 1e-3 / atol 1e-4 (``test_training.py``'s tensor-mesh cases
hold JAX's own mesh step to its single-device one). Each tensor rank holds
1/tp of every tensor-sharded leaf; ``ce_impl="fused"`` on a tensor mesh
gives JAX's warning and its chunked head's numbers; Adafactor and Muon on
fsdp x tensor blocks match JAX's step; a head count that does not split
raises ``ValueError`` in both packages; the train
step's plan takes JAX's ``wkv`` rule at the mesh's tensor size; gloo ranks
on the CPU keep their collectives there."""

import dataclasses

import pytest
from _torch_parallel_jax import check_against_jax, jax_run, tiny_config
from _torch_ranks import RankGroup
from _torch_threads import _one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def ranks():
    group = RankGroup(4)
    yield group
    group.close()


FSDP_TP = (1, 2, 2, 1, 1, 1)
DATA_TP = (2, 1, 2, 1, 1, 1)
MODELS = {"mha-learned-tied": {}}


@pytest.mark.parametrize("sizes,model", [(FSDP_TP, "mha-learned-tied"), (DATA_TP, "mha-learned-tied")],
                         ids=["fsdp2-tensor2-mha", "data2-tensor2-mha"])
def test_tensor_train_steps_match_jax_mesh(ranks, sizes, model):
    cfg = tiny_config(**MODELS[model])
    params_np, x, y, metrics, flat = jax_run(cfg, sizes)
    results = ranks.run("_torch_parallel_cases:train_steps", cfg_dict=dataclasses.asdict(cfg),
                        params_np=params_np, x=x, y=y, sizes=sizes)
    check_against_jax(results, metrics, flat)
    m = cfg.model
    for r in results:
        wo, sl = r["blocks"]["params/blocks/attn/wo"]
        assert wo.shape[1] == m.n_heads // 2 and sl[1][1] - sl[1][0] == m.n_heads // 2
        w2, _ = r["blocks"]["params/blocks/mlp/w2"]
        assert w2.shape[1] == m.d_ff // 2
        emb, _ = r["blocks"]["params/tok_embed/embedding"]
        assert emb.shape[0] == m.vocab_size // 2


def test_fused_ce_on_a_tensor_mesh_warns_as_jax(ranks):
    """``ce_impl="fused"`` on a tensor mesh: JAX's warning, word for word,
    and its chunked head's loss."""
    import warnings

    import numpy as np

    from pretraining_llm_tpu.models import transformer as jtf
    from pretraining_llm_tpu.parallel.sharding import activation_mesh

    cfg = tiny_config(ce_impl="fused", tie_embeddings=False)
    params_np, x, y, metrics, _ = jax_run(cfg, DATA_TP, steps=1)
    import jax
    from jax.sharding import Mesh

    mesh = Mesh(np.array(jax.devices()[:4]).reshape(DATA_TP), ("data", "fsdp", "tensor", "seq", "expert", "pipe"))
    with warnings.catch_warnings(record=True) as caught, activation_mesh(mesh):
        warnings.simplefilter("always")
        jtf.loss_fn(jax.tree.map(jax.numpy.asarray, params_np), x, y, cfg.model)
    want = {str(w.message) for w in caught if "degraded" in str(w.message)}
    results = ranks.run("_torch_parallel_cases:train_steps_warned", cfg_dict=dataclasses.asdict(cfg),
                        params_np=params_np, x=x, y=y, sizes=DATA_TP)
    for r in results:
        assert {msg for _, msg in r["warnings"] if "degraded" in msg} == want and want
        assert abs(r["metrics"][0]["loss"] - metrics[0]["loss"]) <= 1e-5 * abs(metrics[0]["loss"])


@pytest.mark.parametrize("train,model,error", [
    (dict(optimizer="adafactor"), dict(qkv_bias=False), None),
    (dict(optimizer="muon"), {}, None),
    ({}, dict(n_heads=3, d_model=48), ("ValueError", "blocks/attn/wqkv: dimension 3 of size 3 does not split "
                                                     "evenly over mesh axis tensor")),
], ids=["adafactor", "muon", "uneven-heads"])
def test_tensor_mesh_refusals(ranks, train, model, error):
    """Adafactor and Muon on fsdp x tensor blocks (refused until they were
    ported) now match JAX's mesh step; a head count that does not split
    over 'tensor' is refused with ``ValueError`` by both packages (JAX's
    ``shard_train_state`` in ``jax.device_put``). Adafactor runs without
    the qkv bias: the key bias's gradient is zero up to rounding, and
    Adafactor (eps1 1e-30) scales that rounding to full-size updates, so
    even JAX's own mesh step and its one-device step part there by 3e-3."""
    import re

    cfg = tiny_config(**model)
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, **train))
    if error is None:
        params_np, x, y, metrics, flat = jax_run(cfg, FSDP_TP)
        assert any(k.startswith("opt/v/" if train["optimizer"] == "adafactor" else "opt/s/") for k in flat)
        results = ranks.run("_torch_parallel_cases:train_steps", cfg_dict=dataclasses.asdict(cfg),
                            params_np=params_np, x=x, y=y, sizes=FSDP_TP)
        check_against_jax(results, metrics, flat)
        return
    for got in ranks.run("_torch_parallel_cases:train_error", cfg_dict=dataclasses.asdict(cfg), sizes=FSDP_TP):
        assert got is not None and got[0] == error[0] and re.search(error[1], got[1]), got
    import jax
    import numpy as np
    from jax.sharding import Mesh

    from pretraining_llm_tpu.training import train_step as jts

    mesh = Mesh(np.array(jax.devices()[:4]).reshape(FSDP_TP), ("data", "fsdp", "tensor", "seq", "expert", "pipe"))
    with pytest.raises(ValueError, match="should be divisible by 2, but it is equal to 3"):
        jts.shard_train_state(jts.init_train_state(cfg, jax.random.key(0)), mesh, cfg)


@pytest.mark.parametrize("g", [4, 3])
def test_plan_takes_the_jax_wkv_rule_at_the_mesh_tensor_size(ranks, g):
    """``MeshPlan`` builds its spec tree at the mesh's tensor size: the GQA
    ``wkv`` splits its G heads over 'tensor' where G divides tp (G 4), as
    JAX's rule does, and stays whole otherwise (G 3), its gradient then
    summed over 'tensor' as well as the token axes."""
    from pretraining_llm_tpu.parallel.sharding import param_pspec

    cfg = tiny_config(pos_embed="rope", n_heads=12, n_kv_heads=g, d_model=48)
    jax_spec = tuple(param_pspec(("blocks", "attn", "wkv"), 5, shape=(2, 48, 2, g, 4), tensor_size=2))
    for layout in ranks.run("_torch_parallel_cases:plan_layout", cfg_dict=dataclasses.asdict(cfg), sizes=DATA_TP):
        split, summed = layout["blocks/attn/wkv"]
        assert split == (["tensor"] if "tensor" in jax_spec else [])
        assert summed == (["data"] if g == 4 else ["data", "tensor"])
        assert list(layout["blocks/attn/wq"]) == [["tensor"], ["data"]]
        assert list(layout["blocks/ln1/scale"]) == [[], ["data"]]


def test_gloo_cpu_ranks_keep_their_collectives_on_the_cpu(ranks):
    """Four gloo ranks with CPU tensors: ``mesh_device_type`` says "cpu",
    small collectives go on the CPU, and the wrappers' results land on the
    tensors' device."""
    for r in ranks.run("_torch_parallel_cases:collectives_on_tensors"):
        assert r["type"] == "cpu" and r["device"] == "cpu"
        assert r["sum_device"] == "cpu" and r["gathered_device"] == "cpu"
        assert r["sum"] == [6.0, 6.0] and r["gathered"] == [0.0, 0.0, 1.0, 1.0, 2.0, 2.0, 3.0, 3.0]
        assert r["agree"] is True
