"""Cases the gloo ranks of ``_torch_ranks.RankGroup`` run for the port's
pipeline tests (``test_torch_parallel_pipeline*.py``). Imports only torch,
numpy and the port; every function takes and returns plain Python and
numpy values."""

import torch

from _torch_parallel_cases import get_mesh, rank_rows


def pipelined_forward_and_grads(cfg_dict, params_np, tokens, targets, sizes):
    """The pipelined ``forward`` (logits of this rank's rows, every
    column, and the aux loss) and ``loss_fn``'s gradients with respect to
    the full parameters on every rank, under the mesh: each rank's loss is
    its part of the global mean, so the ranks' gradients sum to the
    global one (the test sums them). Also this rank's pipe coordinate."""
    from pretraining_llm_tpu_torch.config import Config
    from pretraining_llm_tpu_torch.models import bridge, transformer
    from pretraining_llm_tpu_torch.parallel import mesh as pmesh
    from pretraining_llm_tpu_torch.parallel.sharding import activation_mesh
    from pretraining_llm_tpu_torch.training import optimizer as opt

    cfg = Config.from_dict(cfg_dict).model
    mesh = get_mesh(sizes)
    rows = rank_rows(sizes, tokens.shape[0])
    x, y = torch.from_numpy(tokens[rows]), torch.from_numpy(targets[rows])
    params = opt.tree_map(lambda p: p.requires_grad_(True), bridge.params_from_numpy(params_np, cfg, device="cpu"))
    with activation_mesh(mesh):
        with torch.no_grad():
            logits, _, aux = transformer.forward(params, x, cfg, return_aux=True)
        loss = transformer.loss_fn(params, x, y, cfg)
    loss.backward()
    grads = {"/".join(p): t.grad.numpy() for p, t in opt.tree_leaves(params)}
    return {"logits": logits.numpy(), "aux": float(aux), "loss": float(loss.detach()), "grads": grads,
            "rows": [rows.start, rows.stop], "pipe": pmesh.coordinate(mesh)["pipe"]}


def forward_error(cfg_dict, params_np, tokens, sizes, baked=False):
    """The (type, message) of the error the pipelined forward raises on
    this rank's rows, or None."""
    from pretraining_llm_tpu_torch.config import Config
    from pretraining_llm_tpu_torch.models import bridge, transformer
    from pretraining_llm_tpu_torch.parallel.sharding import activation_mesh

    cfg = Config.from_dict(cfg_dict).model
    mesh = get_mesh(sizes)
    params = bridge.params_from_numpy(params_np, cfg, device="cpu")
    try:
        with activation_mesh(mesh), torch.no_grad():
            transformer.forward(params, torch.from_numpy(tokens[rank_rows(sizes, tokens.shape[0])]), cfg,
                                blocks_baked=baked)
    except ValueError as e:
        return type(e).__name__, str(e)
    return None


def hop_counts(cfg_dict, sizes, n_rows):
    """One pipelined forward and backward of ones through layers that
    multiply by a weight of ones, counting this rank's layer runs and the
    hops it sends and receives: in the forward, and forward and backward
    together; with the input's gradient and the rank's output columns."""
    from pretraining_llm_tpu_torch.config import Config
    from pretraining_llm_tpu_torch.parallel import mesh as pmesh
    from pretraining_llm_tpu_torch.parallel import pipeline

    cfg = Config.from_dict(cfg_dict).model
    mesh = get_mesh(sizes)
    counts = {"layers": 0, "sends": 0, "recvs": 0}
    real = pipeline._p2p

    def spy(send, recv, group):
        counts["sends"] += send is not None
        counts["recvs"] += recv is not None
        real(send, recv, group)

    s = pmesh.axis_size(mesh, "pipe")
    w = torch.ones(cfg.n_layers // s, 4, requires_grad=True)

    def block(blk, h):
        counts["layers"] += 1
        return h * blk, None

    pipeline._p2p = spy
    try:
        x = torch.ones(n_rows, 4 * s, 4, requires_grad=True)
        y, _ = pipeline.pipeline_apply([w[i] for i in range(w.shape[0])], x, mesh, block,
                                       n_micro=cfg.pipeline_microbatches, interleave=cfg.pipeline_interleave)
        forward = dict(counts)
        y.sum().backward()
    finally:
        pipeline._p2p = real
    return {"forward": forward, "total": counts, "x_grad": x.grad.numpy(), "y": y.detach().numpy()}
