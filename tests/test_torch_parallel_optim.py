"""Adafactor and Muon on sharded leaves, on 4 gloo ranks against the JAX
package's ``build_train_step`` on the same mesh shape (conftest's virtual
CPU devices): the tiny preset at fp32, 2 steps, the bars of
``_torch_parallel_jax.check_against_jax`` (loss rtol 1e-5, grad norm rtol
1e-4, the ranks' blocks of the parameters and of the optimizer's state
against JAX's rtol 1e-3 / atol 1e-4) and each parameter's change over the
steps against JAX's within 1% of its largest change
(``check_updates``).

- Adafactor at tensor 2 x pipe 2 with V 2 (JAX's ``tests/test_optimizer.py``
  sharded case): the statistics are replicated, as JAX's spec has them,
  and in the baked layout; each rank sums its block of the gradient's
  squares into the row and column statistics over the ranks that split
  the summed dim, and the update's RMS over every rank of the leaf, the
  stacked layers included. Without the qkv bias: its key part's gradient is zero up to
  rounding, which Adafactor scales to full-size updates (JAX's own mesh
  and one-device steps part there by 3e-3).
- Muon at tensor 2 x pipe 2 with V 2, and on a MoE model (4 experts,
  top 2, swiglu) at fsdp 2 x expert 2: the momentum is sharded like its
  parameter; each (layer, expert) matrix is gathered over the fsdp and
  tensor ranks that cut it and orthogonalized whole; the pipe and expert
  splits cut the batch of matrices and stay local. (Both optimizers at
  fsdp 2 x tensor 2 are ``test_torch_parallel_tensor.py``'s.)"""

import dataclasses

import pytest
from _torch_parallel_jax import check_against_jax, check_updates, jax_run, tiny_config
from _torch_ranks import RankGroup
from _torch_threads import _one_torch_thread  # noqa: F401

TENSOR2_PIPE2 = (1, 1, 2, 1, 1, 2)
FSDP2_EXPERT2 = (1, 2, 1, 1, 2, 1)
MOE = dict(n_experts=4, experts_per_token=2, activation="swiglu")
V2 = dict(n_layers=4, pipeline_stages=2, pipeline_interleave=2, pipeline_microbatches=2)


@pytest.fixture(scope="module")
def ranks():
    group = RankGroup(4)
    yield group
    group.close()


@pytest.mark.parametrize("optimizer,sizes,model", [
    ("adafactor", TENSOR2_PIPE2, dict(V2, qkv_bias=False)),
    ("muon", TENSOR2_PIPE2, V2),
    ("muon", FSDP2_EXPERT2, MOE),
], ids=["adafactor-tensor2-pipe2-v2", "muon-tensor2-pipe2-v2", "muon-fsdp2-expert2-moe"])
def test_sharded_optimizer_steps_match_jax_mesh(ranks, optimizer, sizes, model):
    cfg = tiny_config(**model)
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, optimizer=optimizer))
    params_np, x, y, metrics, flat = jax_run(cfg, sizes)
    state_key = "opt/v/" if optimizer == "adafactor" else "opt/s/"
    assert any(k.startswith(state_key) for k in flat)
    results = ranks.run("_torch_parallel_cases:train_steps", cfg_dict=dataclasses.asdict(cfg),
                        params_np=params_np, x=x, y=y, sizes=sizes)
    check_against_jax(results, metrics, flat)
    check_updates(results, params_np, flat, cfg, interleave=cfg.model.pipeline_interleave)
    for r in results:
        split = [n for n, (b, _) in r["blocks"].items() if n.startswith(state_key) and b.shape != flat[n].shape]
        if optimizer == "adafactor":
            assert not split  # replicated statistics
        else:
            assert split  # the momentum is sharded like its parameter
