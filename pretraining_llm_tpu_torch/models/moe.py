"""Mixture-of-experts MLP: the port's counterpart of
``pretraining_llm_tpu/models/moe.py``.

The same function as the JAX module: token-choice top-k routing per group of
``cfg.moe_group_size`` tokens (the group count depends on the token count
only), a static capacity per expert and group, slot-major priority (every
token's first choice is placed before any token's second), renormalized
gates, dropped (token, choice) pairs contributing 0, the Switch-style
load-balance loss, and one expert FFN per expert over its (G * C) slots.

Where the JAX module dispatches and combines by einsums against one-hot
(G, S, E, C) tensors (the form that lowers to an all-to-all on a mesh), the
port moves rows by index: each capacity slot holds exactly one token, and
each token sums its k kept expert outputs times its gate, so a gather in
each direction computes the same values without the one-hots (at
moe-8x350m's size each einsum would cost 21.5 GFLOP a group and a layer).
The gathers' backward passes are gathers too, through the inverse index
(``_RowGather``), so no step sums with atomics and every result repeats
bit for bit. Gate weights and the combine sum are fp32 and rounded once to
h's dtype on every device: the JAX module's form on the CPU (``ddt``); on
the TPU it rounds the gates to bf16.

On a mesh (``parallel.sharding.activation_mesh``) the port issues what
GSPMD gives the JAX module. The tokens are replicated over the expert ranks
of a data group (JAX's batch spec has no 'expert' entry): every expert
rank routes the same tokens alike and runs its E/ep experts' FFNs on its
slots, the dispatched input passes ``copy_to_group`` and the combined
output is summed over the expert (and tensor) ranks. Where the data x
fsdp ranks split the rows (a train or eval step) the routing groups are
the global batch's: the router's logits are all-gathered over those
ranks, every rank routes the whole batch as the JAX module does, and
keeps its tokens' decisions, so capacity drops and the load-balance loss
are the global batch's. With ring or Ulysses attention over the seq axis a
row's tokens are split over the seq ranks too: the logits are gathered
over data x fsdp x seq and put in the global (B, T) token order, the JAX
module's, before the groups are cut. A rank's slots are its experts' over the groups
its tokens touch (a group that spans ranks leaves the other ranks' slots
empty). With a tensor axis each expert FFN is column- then row-parallel
over it, and ``b2`` is added on tensor rank 0 only (its gradient is then
summed over 'tensor' by the train step).

No kernel: the JAX module reaches no ``pl.pallas_call``. The expert
products are ``torch.bmm`` in the compute dtype (fp32 accumulation, one
rounding), as the JAX einsums with ``preferred_element_type=f32`` then
``astype(cdt)`` are.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from pretraining_llm_tpu_torch.config import ModelConfig
from pretraining_llm_tpu_torch.models import layers
from pretraining_llm_tpu_torch.ops import remat
from pretraining_llm_tpu_torch.parallel.mesh import coordinate
from pretraining_llm_tpu_torch.parallel.sharding import current_mesh, rows_split, sequence_shards
from pretraining_llm_tpu_torch.parallel.tensor import copy_to_group, gather_rows, layer_group, sum_over_group

Params = Dict[str, Any]


def param_shapes(cfg: ModelConfig) -> Params:
    """One block's MoE parameter shapes, the JAX ``init_moe_params`` tree:
    router (D, E) and the stacked expert FFNs (E, ...). ``transformer.
    init_params`` gives them ``init_moe_params``'s distributions (router and
    w1 N(0, 0.02), w2 the residual std, biases zero)."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    if cfg.activation == "swiglu":
        experts: Params = {"w1": (e, d, 2, f), "w2": (e, f, d)}
        if cfg.mlp_bias:
            experts.update(b1=(e, 2, f), b2=(e, d))
    else:
        experts = {"w1": (e, d, f), "w2": (e, f, d)}
        if cfg.mlp_bias:
            experts.update(b1=(e, f), b2=(e, d))
    return {"router": (d, e), "experts": experts}


def expert_capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Static per-expert slot count for a group of n_tokens."""
    cap = int(cfg.expert_capacity_factor * cfg.experts_per_token * n_tokens / cfg.n_experts)
    return max(1, min(cap, n_tokens))


def _group_count(s: int, group_size: int) -> int:
    """Number of routing groups: S / group_size rounded down to a divisor of
    S (one group for group_size 0 or S <= group_size)."""
    if group_size <= 0 or s <= group_size:
        return 1
    g = s // group_size
    while s % g != 0:
        g -= 1
    return g


class Routing(NamedTuple):
    """Routing decisions of G groups of S tokens, k choices each."""

    idx: torch.Tensor  # (G, S, k) int64 expert of each choice
    gate: torch.Tensor  # (G, S, k) fp32 renormalized gate (before dropping)
    pos: torch.Tensor  # (G, S, k) int32 position in the expert's capacity
    keep: torch.Tensor  # (G, S, k) bool: pos < capacity
    aux: torch.Tensor  # (G,) fp32 load-balance loss per group


def route(router_logits: torch.Tensor, cfg: ModelConfig, capacity: int) -> Routing:
    """Token-choice top-k routing with capacity over router_logits (G, S, E)
    fp32 (JAX ``route``, batched over groups). Top-k takes the lower expert
    index first on equal probabilities, as ``jax.lax.top_k`` does (a stable
    descending sort). Positions are integer cumsums over the slot-major
    (k * S, E) layout."""
    g, s, e = router_logits.shape
    k = cfg.experts_per_token
    probs = torch.softmax(router_logits, dim=-1)
    top, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = top[..., :k], order[..., :k]
    gate = gate / gate.sum(dim=-1, keepdim=True)
    # (G, S, k, E) 0/1 by an iota compare: ``one_hot`` reads its indices'
    # range back to the host, a wait for the card in every layer.
    onehot = (idx[..., None] == torch.arange(e, device=idx.device)).int()
    # Each expert's running count in slot-major order (every token's first
    # choice before any token's second), scanned along a contiguous (k * S)
    # axis per (group, expert).
    slot_major = onehot.permute(0, 3, 2, 1).reshape(g, e, k * s)
    counts = (torch.cumsum(slot_major, dim=-1, dtype=torch.int32) - slot_major).reshape(g, e, k, s)
    pos = counts.permute(0, 3, 2, 1).gather(3, idx[..., None])[..., 0]
    frac = onehot.sum(dim=2).float().mean(dim=1) / k  # (G, E)
    aux = e * (frac * probs.mean(dim=1)).sum(dim=-1)
    return Routing(idx, gate, pos, pos < capacity, aux)


class _RowGather(torch.autograd.Function):
    """out = src[index] with index value len(src) giving a zero row. The
    backward gathers the output's gradient rows back through ``inverse``
    (len(out rows) gives a zero row) and sums over inverse's second axis, if
    it has one, in fp32: each source row's uses, in choice order."""

    @staticmethod
    def forward(ctx, src, index, inverse):
        ctx.save_for_backward(index, inverse)
        pad = torch.cat([src, src.new_zeros((1,) + src.shape[1:])])
        return pad[index]

    @staticmethod
    def backward(ctx, grad):
        index, inverse = ctx.saved_tensors
        flat = grad.reshape((index.numel(),) + grad.shape[index.ndim:])
        back = torch.cat([flat, flat.new_zeros((1,) + flat.shape[1:])])[inverse]
        if inverse.ndim > 1:
            back = back.float().sum(dim=1).to(grad.dtype)
        return back, None, None


def moe_mlp(mlp: Params, h: torch.Tensor, cfg: ModelConfig, *, decode: bool = False,
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE FFN on normed input h (B, T, D) -> (output (B, T, D) in h's
    dtype, aux loss fp32 scalar: the mean over groups).

    ``decode=True`` (a cached forward of one token per row) routes the call
    as one group with capacity = its token count, so no token is dropped and
    a row's output does not depend on the rows batched with it. On a mesh,
    h is the rank's rows and the aux loss the global batch's."""
    cdt = getattr(torch, cfg.compute_dtype)  # "float32", "bfloat16", "float16"
    b, t, d = h.shape
    n = b * t
    e, k = cfg.n_experts, cfg.experts_per_token
    mesh = current_mesh()
    split = rows_split() and not decode
    n_seq = sequence_shards(cfg, mesh) if split else 1
    tokens = layer_group(mesh, ("data", "fsdp", "seq") if n_seq > 1 else ("data", "fsdp")) if split else None
    ranks = layer_group(mesh, ("tensor", "expert"))  # partial outputs, summed
    n_all = n * (1 if tokens is None else tokens.size)
    g = 1 if decode else _group_count(n_all, cfg.moe_group_size)
    sg = n_all // g
    capacity = sg if decode else expert_capacity(cfg, sg)
    x = h.reshape(n, d)
    logits = gather_rows(x.float() @ mlp["router"].float(), tokens)
    # The global token order of the JAX module: row-major over the global
    # (B, T), whose columns the seq ranks split (each rank's T / n_seq, in
    # the order the model sees them: zigzag's under its layout). The
    # group's blocks arrive in rank order, (rows, seq) with seq fastest.
    rb, j = (0, 0) if tokens is None else divmod(tokens.index, n_seq)
    if n_seq > 1:
        logits = logits.reshape(-1, n_seq, b, t, e).transpose(1, 2).reshape(n_all, e)
    r = route(logits.reshape(g, sg, e), cfg, capacity)
    # This rank's tokens in the routed order: row rb * b + i, columns
    # j * t .. (j + 1) * t - 1 of the global (B, n_seq * t).
    row_len = n_seq * t
    t0 = rb * b * row_len + j * t
    tok = (t0 + torch.arange(b, device=h.device)[:, None] * row_len
           + torch.arange(t, device=h.device)[None, :]).reshape(n)
    idx, gate, pos, keep = (a.reshape(n_all, k)[tok] for a in (r.idx, r.gate, r.pos, r.keep))

    # Slot m = expert * (G * C) + group * C + position: the JAX layout of
    # the (E, G * C, D) expert batch (token i = group * S + s), over this
    # rank's experts and the groups its tokens touch.
    ex = mlp["experts"]
    e_loc = ex["w2"].shape[0]
    e0 = coordinate(mesh)["expert"] * e_loc if e_loc < e else 0
    g_lo = t0 // sg
    g_n = (t0 + (b - 1) * row_len + t - 1) // sg - g_lo + 1
    m_slots = e_loc * g_n * capacity
    group = torch.div(tok, sg, rounding_mode="floor") - g_lo
    local = idx - e0
    mine = keep & (local >= 0) & (local < e_loc)
    slot = local * (g_n * capacity) + group[:, None] * capacity + pos
    slot_of = torch.where(mine, slot, torch.full_like(slot, m_slots))
    # The inverse maps: each slot's token (n: empty) and (token, choice)
    # (n * k: empty). Dropped choices scatter into the extra last entry,
    # which is cut off, so no step waits for a count of kept choices.
    choices = torch.arange(n * k, device=h.device)
    token_of = torch.full((m_slots + 1,), n, dtype=torch.long, device=h.device)
    token_of = token_of.scatter(0, slot_of.reshape(-1), choices // k)[:m_slots]
    choice_of = torch.full((m_slots + 1,), n * k, dtype=torch.long, device=h.device)
    choice_of = choice_of.scatter(0, slot_of.reshape(-1), choices)[:m_slots]

    xin = _RowGather.apply(copy_to_group(x.to(cdt), ranks), token_of, slot_of).reshape(e_loc, g_n * capacity, d)
    if cfg.activation == "swiglu":
        f = ex["w2"].shape[1]
        gates = torch.bmm(xin, ex["w1"].to(cdt).reshape(e_loc, d, 2 * f)).reshape(e_loc, -1, 2, f)
        if "b1" in ex:
            gates = gates + ex["b1"].to(cdt)[:, None]
        act = torch.nn.functional.silu(gates[..., 0, :])
        with remat.site("mlp_hidden"):  # the remat tag on the activation's last op
            hidden = act * gates[..., 1, :]
    else:
        hidden = torch.bmm(xin, ex["w1"].to(cdt))
        if "b1" in ex:
            hidden = hidden + ex["b1"].to(cdt)[:, None]
        with remat.site("mlp_hidden"):
            hidden = layers.activation_fn(cfg.activation, hidden)
    out = torch.bmm(hidden, ex["w2"].to(cdt))
    if "b2" in ex and (mesh is None or coordinate(mesh)["tensor"] == 0):
        out = out + ex["b2"].to(cdt)[:, None]

    picked = _RowGather.apply(out.reshape(m_slots, d), slot_of, choice_of)  # (N, k, D)
    weights = copy_to_group(gate * keep, ranks).reshape(n, k, 1)
    y = sum_over_group((weights * picked.float()).sum(dim=1), ranks)
    return y.to(h.dtype).reshape(b, t, d), r.aux.mean()
