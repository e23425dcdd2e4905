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
    """The message of the error ``impl`` raises on these (global) heads,
    the rank holding its tensor shard of them, or None."""
    from pretraining_llm_tpu_torch.parallel.ring_attention import ring_attention
    from pretraining_llm_tpu_torch.parallel.ulysses import ulysses_attention

    mesh = get_mesh(sizes)
    n, tp = pmesh.axis_size(mesh, "seq"), pmesh.axis_size(mesh, "tensor")
    q = torch.zeros(1, t // n, h // tp, 8)
    kv = torch.zeros(1, t // n, g // tp, 8)
    fn = ring_attention if impl == "ring" else ulysses_attention
    try:
        fn(q, kv, kv, mesh)
    except ValueError as e:
        return str(e)
    return None


def train_steps_warned(cfg_dict, params_np, x, y, sizes, steps=1):
    """``train_steps`` with the warnings it raised, as (category, message)
    pairs."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = train_steps(cfg_dict, params_np, x, y, sizes, steps)
    out["warnings"] = [(w.category.__name__, str(w.message)) for w in caught]
    return out


def train_error(cfg_dict, sizes):
    """The (type, message) of the error the port's mesh train step raises
    for this config on this mesh, or None."""
    from pretraining_llm_tpu_torch.config import Config
    from pretraining_llm_tpu_torch.training import train_step as ts

    cfg = Config.from_dict(cfg_dict)
    mesh = get_mesh(sizes)
    try:
        state = ts.init_train_state(cfg, 0, device="cpu", mesh=mesh)
        ts.build_train_step(cfg, mesh)
        del state
    except ValueError as e:
        return type(e).__name__, str(e)
    return None


def build_mesh_error(**axes):
    """The message of the error ``build_mesh`` raises for a mesh of these
    axes, or None (then the mesh's shape)."""
    try:
        mesh = pmesh.build_mesh(MeshConfig(**axes), "cpu")
    except (ValueError, NotImplementedError) as e:
        return str(e)
    assert pmesh.mesh_shape(mesh) == {a: axes.get(a, 1) for a in mesh.mesh_dim_names}
    return None


def rank_rows(sizes, batch):
    """This rank's rows of a global batch: its data x fsdp block."""
    mesh = get_mesh(sizes)
    shape, c = pmesh.mesh_shape(mesh), pmesh.coordinate(mesh)
    rows = batch // (shape["data"] * shape["fsdp"])
    k = c["data"] * shape["fsdp"] + c["fsdp"]
    return slice(k * rows, (k + 1) * rows)


def train_steps(cfg_dict, params_np, x, y, sizes, steps=2, save_dir=None):
    """``steps`` steps of the port's mesh train step from the given full
    parameters on this rank's rows of the global batch (x, y). Returns the
    metrics and this rank's blocks of the parameters and the optimizer's
    state, each with its [start, stop) per dimension in the global leaf
    (in the baked layout of an interleaved pipeline, as JAX's state holds
    it). ``save_dir``: then write a checkpoint of the state there, as the
    trainer writes it (depth-major)."""
    from pretraining_llm_tpu_torch.config import Config
    from pretraining_llm_tpu_torch.models import bridge
    from pretraining_llm_tpu_torch.parallel.sharding import local_slices
    from pretraining_llm_tpu_torch.training import checkpoint as ckpt
    from pretraining_llm_tpu_torch.training import optimizer as opt
    from pretraining_llm_tpu_torch.training import train_step as ts

    cfg = Config.from_dict(cfg_dict)
    mesh = get_mesh(sizes)
    params = bridge.params_from_numpy(params_np, cfg.model, device="cpu")
    full = {"params": params, "opt": opt.optimizer_init(params, cfg.train),
            "step": torch.zeros((), dtype=torch.int32)}
    specs = ts.state_pspec_tree(full, ts._is_pipelined(cfg, mesh), tensor_size=pmesh.axis_size(mesh, "tensor"))
    shapes = {"/".join(p): tuple(t.shape) for p, t in opt.tree_leaves(full)}
    state = ts.shard_train_state(full, mesh, cfg)
    step = ts.build_train_step(cfg, mesh)
    rows = rank_rows(sizes, x.shape[0])
    metrics = []
    for _ in range(steps):
        state, m = step(state, (torch.from_numpy(x[rows]), torch.from_numpy(y[rows])))
        metrics.append({k: float(v) for k, v in m.items()})
    if save_dir is not None:
        ckpt.save_checkpoint(save_dir, steps, ts.save_view(state, cfg, mesh),
                             layout=ts.checkpoint_layout(ts.state_template(cfg), mesh, cfg),
                             extra={"step": steps, "block_layout": "depth_major"})
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
    last logged metrics, the exit reason, the state's leaves (this rank's
    blocks) as the trainer started (``restored``) and as it ended, the
    rank's mesh coordinate, and with ``eval_iters`` the trainer's
    ``evaluate``."""
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
    start, restored = trainer.start_step, _state_blocks(trainer.state)
    last = trainer.train(steps=steps)
    if eval_iters:
        last["eval"] = trainer.evaluate(eval_iters)
    return {"start": start, "last": last, "exit_reason": trainer.exit_reason, "restored": restored,
            "state": _state_blocks(trainer.state), "rows": [trainer._rows.start, trainer._rows.stop],
            "coord": None if trainer.mesh is None else pmesh.coordinate(trainer.mesh)}


def compile_only_sizes(cfg_dict, sizes):
    """``train --compile-only``'s shape bytes of this rank on the mesh."""
    from pretraining_llm_tpu_torch import train as train_cli
    from pretraining_llm_tpu_torch.config import Config

    return train_cli.shape_bytes(Config.from_dict(cfg_dict), get_mesh(sizes))


def moe_layer(cfg_dict, mlp_np, h, sizes):
    """One MoE MLP (``models.moe.moe_mlp``) on this rank's rows of the
    global (B, T, D) input h, with its blocks of the layer's parameters
    under the mesh: the rank's output rows and the aux loss."""
    from pretraining_llm_tpu_torch.config import Config
    from pretraining_llm_tpu_torch.models import moe
    from pretraining_llm_tpu_torch.parallel.sharding import (
        activation_mesh, param_pspec_tree, sequence_shards, shard_tree,
    )

    cfg = Config.from_dict(cfg_dict)
    mesh = get_mesh(sizes)
    tree = {"mlp": {"router": torch.from_numpy(mlp_np["router"]),
                    "experts": {k: torch.from_numpy(v) for k, v in mlp_np["experts"].items()}}}
    local = shard_tree(tree, param_pspec_tree(tree, tensor_size=pmesh.axis_size(mesh, "tensor")), mesh)
    rows = rank_rows(sizes, h.shape[0])
    n_seq = sequence_shards(cfg.model, mesh)
    tl = h.shape[1] // n_seq
    cols = slice(pmesh.coordinate(mesh)["seq"] * tl, (pmesh.coordinate(mesh)["seq"] + 1) * tl)
    with activation_mesh(mesh):
        y, aux = moe.moe_mlp(local["mlp"], torch.from_numpy(np.ascontiguousarray(h[rows, cols])), cfg.model)
    return {"y": y.numpy(), "aux": float(aux), "rows": [rows.start, rows.stop], "cols": [cols.start, cols.stop]}


def inference_blocks(cfg_dict, params_np, sizes, quantize=False):
    """``shard_params_for_inference``'s blocks of the full parameters (int8
    quantized first, with ``quantize``), and, for the quantized tree, the
    blocks that quantizing the rank's own float blocks gives (what the
    serving engine does on a mesh)."""
    from pretraining_llm_tpu_torch.config import Config
    from pretraining_llm_tpu_torch.generation.generate import mesh_params, shard_params_for_inference
    from pretraining_llm_tpu_torch.models import bridge
    from pretraining_llm_tpu_torch.models import quantize as tq
    from pretraining_llm_tpu_torch.parallel.tensor import tensor_group
    from pretraining_llm_tpu_torch.training import optimizer as opt

    cfg = Config.from_dict(cfg_dict)
    mesh = get_mesh(sizes)
    params = bridge.params_from_numpy(params_np, cfg.model, device="cpu")
    full = tq.quantize_params_for_serving(params, cfg.model) if quantize else params
    out = {"blocks": {"/".join(p): t.numpy() for p, t in opt.tree_leaves(shard_params_for_inference(full, mesh))}}
    if quantize:
        local = mesh_params(shard_params_for_inference(params, mesh), cfg.model, mesh)
        q = tq.quantize_params_for_serving(local, cfg.model, tensor_group(mesh))
        out["local_quantized"] = {"/".join(p): t.numpy() for p, t in opt.tree_leaves(q)}
        out["local_full"] = {"/".join(p): t.numpy()
                             for p, t in opt.tree_leaves(mesh_params(full, cfg.model, mesh))}
    return out


def generate_on_mesh(cfg_dict, params_np, prompt, n_new, sizes, prompt_lengths=None):
    """Greedy ``generate(..., mesh=)`` from ``shard_params_for_inference``'s
    blocks: the tokens every rank returns."""
    from pretraining_llm_tpu_torch.config import Config
    from pretraining_llm_tpu_torch.generation.generate import generate, shard_params_for_inference
    from pretraining_llm_tpu_torch.models import bridge

    cfg = Config.from_dict(cfg_dict)
    mesh = get_mesh(sizes)
    params = bridge.params_from_numpy(params_np, cfg.model, device="cpu")
    toks = generate(shard_params_for_inference(params, mesh), cfg.model, prompt, n_new, 7, temperature=0.0,
                    mesh=mesh, prompt_lengths=prompt_lengths)
    return toks.numpy()


def serve_on_mesh(cfg_dict, params_np, prompts, n_new, sizes, engine_kw, pipeline=True, spec_k=0):
    """``ServingEngine(mesh=)`` from ``shard_params_for_inference``'s blocks
    over ``prompts`` (greedy): each request's tokens, the pools' head
    count and the warnings the constructor raised. ``spec_k`` serves
    speculatively with the model as its own draft."""
    import warnings

    from pretraining_llm_tpu_torch.config import Config
    from pretraining_llm_tpu_torch.generation.generate import shard_params_for_inference
    from pretraining_llm_tpu_torch.generation.serving import ServingEngine
    from pretraining_llm_tpu_torch.models import bridge

    cfg = Config.from_dict(cfg_dict)
    mesh = get_mesh(sizes)
    params = bridge.params_from_numpy(params_np, cfg.model, device="cpu")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        sharded = shard_params_for_inference(params, mesh)
        if spec_k:
            engine_kw = dict(engine_kw, draft_params=sharded, draft_cfg=cfg.model, spec_k=spec_k)
        eng = ServingEngine(sharded, cfg.model, temperature=0.0, mesh=mesh, device="cpu", **engine_kw)
    rids = [eng.submit(list(p), n_new) for p in prompts]
    out = eng.run(pipeline=pipeline)
    return {"tokens": [out[r] for r in rids], "pool_heads": int(eng.pools["layers"][0]["k_pool"].shape[2]),
            "warnings": [str(w.message) for w in caught],
            "cached_tokens": sum(eng.req_timing[r].get("cached_tokens", 0) for r in rids)}


def plan_layout(cfg_dict, sizes):
    """The train step's plan on this mesh: {leaf: (the axes that split
    it, the axes its gradient is summed over)}."""
    from pretraining_llm_tpu_torch.config import Config
    from pretraining_llm_tpu_torch.training import train_step as ts

    mesh = get_mesh(sizes)
    plan = ts.MeshPlan(Config.from_dict(cfg_dict), mesh)
    names = mesh.mesh_dim_names
    out = {}
    for path, grp in plan.grad_groups.items():
        summed = tuple(a for a in names if a in _group_axes(mesh, grp))
        out["/".join(path)] = (list(plan.split_axes.get(path, ())), list(summed))
    return out


def _group_axes(mesh, grp):
    """The axes along which a group's ranks differ from this rank."""
    coords = {r: dict(zip(mesh.mesh_dim_names, [int(i) for i in (mesh.mesh == r).nonzero()[0]]))
              for r in grp.ranks}
    me = coords[grp.ranks[grp.index]]
    return {a for c in coords.values() for a in c if c[a] != me[a]}


def collectives_on_tensors():
    """Where a gloo world of CPU ranks says its tensors live, and where its
    collectives leave their results."""
    import torch.distributed as dist

    from pretraining_llm_tpu_torch.parallel import tensor as ptensor

    x = torch.full((2,), float(dist.get_rank()))
    ptensor.all_reduce(x, dist.group.WORLD)
    out = torch.empty(2 * dist.get_world_size())
    ptensor.all_gather_into(out, torch.full((2,), float(dist.get_rank())), dist.group.WORLD)
    return {"type": pmesh.mesh_device_type(), "device": str(pmesh.collective_device()),
            "sum": x.tolist(), "sum_device": str(x.device), "gathered": out.tolist(),
            "gathered_device": str(out.device), "agree": pmesh.all_ranks_agree(True)}


def node_batches(cfg_dict, overrides, n_batches=2):
    """This rank as its own node (``LOCAL_WORLD_SIZE=1``): the port's
    ``Trainer`` on file data, its node's first train batches, its first
    eval batch, the sampler's name and the node's index and count."""
    import io
    import os

    from pretraining_llm_tpu_torch.config import Config
    from pretraining_llm_tpu_torch.training.metrics import MetricsLogger
    from pretraining_llm_tpu_torch.training.trainer import Trainer

    cfg = Config.from_dict(cfg_dict).with_overrides(overrides)
    before = os.environ.get("LOCAL_WORLD_SIZE")
    os.environ["LOCAL_WORLD_SIZE"] = "1"
    try:
        trainer = Trainer(cfg, resume=False, device="cpu", logger=MetricsLogger("", stream=io.StringIO()))
        train = [next(trainer.train_iterator) for _ in range(n_batches)]
        val = next(trainer._fresh_val_iterator())
        return {"node": pmesh.node_index(), "nodes": pmesh.node_count(), "sampler": trainer.sampler,
                "train": train, "val": val, "rows": [trainer._rows.start, trainer._rows.stop]}
    finally:
        if before is None:
            del os.environ["LOCAL_WORLD_SIZE"]
        else:
            os.environ["LOCAL_WORLD_SIZE"] = before
