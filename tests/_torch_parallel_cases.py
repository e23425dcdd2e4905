"""Cases the gloo ranks of ``_torch_ranks.RankGroup`` run for the port's
parallelism tests. Imports only torch, numpy and the port; every function
takes and returns plain Python and numpy values."""

from typing import Dict, Tuple

import numpy as np
import torch

from pretraining_llm_tpu_torch.config import MeshConfig
from pretraining_llm_tpu_torch.parallel import mesh as pmesh

_MESHES: Dict[Tuple[int, ...], object] = {}


def get_mesh(sizes):
    """One DeviceMesh per mesh shape per process (groups are made once)."""
    sizes = tuple(sizes)
    if sizes not in _MESHES:
        names = ("data", "fsdp", "tensor", "seq", "expert", "pipe")
        _MESHES[sizes] = pmesh.build_mesh(MeshConfig(**dict(zip(names, sizes))), "cpu")
    return _MESHES[sizes]


def coordinate(sizes):
    return pmesh.coordinate(get_mesh(sizes))


def attention(impl, q, k, v, do, sizes, causal=True, layout="contiguous", block_kv=512):
    """The rank's seq chunk of the global (B, T, ., D) arrays through
    ``ring_attention`` or ``ulysses_attention``; returns the rank's output
    and q/k/v gradient chunks."""
    from pretraining_llm_tpu_torch.parallel.ring_attention import ring_attention
    from pretraining_llm_tpu_torch.parallel.ulysses import ulysses_attention

    mesh = get_mesh(sizes)
    n = pmesh.axis_size(mesh, "seq")
    r = pmesh.coordinate(mesh)["seq"]
    tl = q.shape[1] // n

    def local(a):
        return torch.from_numpy(np.ascontiguousarray(a[:, r * tl:(r + 1) * tl])).requires_grad_(True)

    ql, kl, vl = local(q), local(k), local(v)
    if impl == "ring":
        o = ring_attention(ql, kl, vl, mesh, causal=causal, layout=layout, block_kv=block_kv)
    else:
        o = ulysses_attention(ql, kl, vl, mesh, causal=causal)
    o.backward(torch.from_numpy(np.ascontiguousarray(do[:, r * tl:(r + 1) * tl])))
    return {"o": o.detach().numpy(), "dq": ql.grad.numpy(), "dk": kl.grad.numpy(), "dv": vl.grad.numpy()}


def attention_error(impl, sizes, h, g, t=16):
    """The message of the error ``impl`` raises on these heads, or None."""
    from pretraining_llm_tpu_torch.parallel.ring_attention import ring_attention
    from pretraining_llm_tpu_torch.parallel.ulysses import ulysses_attention

    mesh = get_mesh(sizes)
    n = pmesh.axis_size(mesh, "seq")
    q = torch.zeros(1, t // n, h, 8)
    kv = torch.zeros(1, t // n, g, 8)
    fn = ring_attention if impl == "ring" else ulysses_attention
    try:
        fn(q, kv, kv, mesh)
    except ValueError as e:
        return str(e)
    return None


def build_mesh_error(**axes):
    """The message of the NotImplementedError ``build_mesh`` raises for a
    mesh of these axes, or None."""
    try:
        pmesh.build_mesh(MeshConfig(**axes), "cpu")
    except NotImplementedError as e:
        return str(e)
    return None


def rank_rows(sizes, batch):
    """This rank's rows of a global batch: its data x fsdp block."""
    mesh = get_mesh(sizes)
    shape, c = pmesh.mesh_shape(mesh), pmesh.coordinate(mesh)
    rows = batch // (shape["data"] * shape["fsdp"])
    k = c["data"] * shape["fsdp"] + c["fsdp"]
    return slice(k * rows, (k + 1) * rows)


def train_steps(cfg_dict, params_np, x, y, sizes, steps=2):
    """``steps`` steps of the port's mesh train step from the given full
    parameters on this rank's rows of the global batch (x, y). Returns the
    metrics and this rank's blocks of the parameters and AdamW's moments,
    each with its [start, stop) per dimension in the global leaf."""
    from pretraining_llm_tpu_torch.config import Config
    from pretraining_llm_tpu_torch.models import bridge
    from pretraining_llm_tpu_torch.parallel.sharding import local_slices
    from pretraining_llm_tpu_torch.training import optimizer as opt
    from pretraining_llm_tpu_torch.training import train_step as ts

    cfg = Config.from_dict(cfg_dict)
    mesh = get_mesh(sizes)
    params = bridge.params_from_numpy(params_np, cfg.model, device="cpu")
    full = {"params": params, "opt": opt.optimizer_init(params, cfg.train),
            "step": torch.zeros((), dtype=torch.int32)}
    specs = ts.state_pspec_tree(full)
    shapes = {"/".join(p): tuple(t.shape) for p, t in opt.tree_leaves(full)}
    state = ts.shard_train_state(full, mesh)
    step = ts.build_train_step(cfg, mesh)
    rows = rank_rows(sizes, x.shape[0])
    metrics = []
    for _ in range(steps):
        state, m = step(state, (torch.from_numpy(x[rows]), torch.from_numpy(y[rows])))
        metrics.append({k: float(v) for k, v in m.items()})
    blocks = {}
    for (path, t), (_, spec) in zip(opt.tree_leaves(state), ts._spec_leaves(specs)):
        name = "/".join(path)
        if path[0] in ("params", "opt") and path[-1] != "count":
            sl = local_slices(spec, shapes[name], mesh)
            blocks[name] = (t.detach().numpy(), [[s.start, s.stop] for s in sl])
    return {"metrics": metrics, "blocks": blocks, "shapes": shapes}


def _state_blocks(state):
    from pretraining_llm_tpu_torch.training import optimizer as opt

    return {"/".join(p): t.detach().clone().numpy() for p, t in opt.tree_leaves(state)}


def trainer_run(cfg_dict, overrides, steps=None, resume=True, faults_on_rank=None, eval_iters=0):
    """Train the port's ``Trainer`` (synthetic data, CPU) on this rank's
    mesh from ``config.mesh``; ``faults_on_rank`` = (rank, spec) sets
    ``resilience.faults`` on that rank only. Returns the start step, the
    last logged metrics, the exit reason and the state's leaves (this
    rank's blocks), and with ``eval_iters`` the trainer's ``evaluate``."""
    import torch.distributed as dist

    from pretraining_llm_tpu_torch.config import Config
    from pretraining_llm_tpu_torch.training.metrics import MetricsLogger
    from pretraining_llm_tpu_torch.training.trainer import Trainer

    over = dict(overrides)
    if faults_on_rank is not None and dist.get_rank() == faults_on_rank[0]:
        over["resilience.faults"] = faults_on_rank[1]
    cfg = Config.from_dict(cfg_dict).with_overrides(over)
    import io

    trainer = Trainer(cfg, synthetic_data=True, resume=resume, device="cpu",
                      logger=MetricsLogger("", stream=io.StringIO()))
    start = trainer.start_step
    last = trainer.train(steps=steps)
    if eval_iters:
        last["eval"] = trainer.evaluate(eval_iters)
    return {"start": start, "last": last, "exit_reason": trainer.exit_reason,
            "state": _state_blocks(trainer.state), "rows": [trainer._rows.start, trainer._rows.stop]}


def compile_only_sizes(cfg_dict, sizes):
    """``train --compile-only``'s shape bytes of this rank on the mesh."""
    from pretraining_llm_tpu_torch import train as train_cli
    from pretraining_llm_tpu_torch.config import Config

    return train_cli.shape_bytes(Config.from_dict(cfg_dict), get_mesh(sizes))
