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
    a row's output does not depend on the rows batched with it."""
    cdt = getattr(torch, cfg.compute_dtype)  # "float32", "bfloat16", "float16"
    b, t, d = h.shape
    n = b * t
    e, k = cfg.n_experts, cfg.experts_per_token
    g = 1 if decode else _group_count(n, cfg.moe_group_size)
    sg = n // g
    capacity = sg if decode else expert_capacity(cfg, sg)
    x = h.reshape(n, d)
    logits = (x.float() @ mlp["router"].float()).reshape(g, sg, e)
    r = route(logits, cfg, capacity)

    # Slot m = expert * (G * C) + group * C + position: the JAX layout of
    # the (E, G * C, D) expert batch. Token i = group * S + s.
    m_slots = e * g * capacity
    groups = torch.arange(g, device=h.device)[:, None, None]
    slot = r.idx * (g * capacity) + groups * capacity + r.pos
    slot_of = torch.where(r.keep, slot, torch.full_like(slot, m_slots)).reshape(n, k)
    # The inverse maps: each slot's token (n: empty) and (token, choice)
    # (n * k: empty). Dropped choices scatter into the extra last entry,
    # which is cut off, so no step waits for a count of kept choices.
    choices = torch.arange(n * k, device=h.device)
    token_of = torch.full((m_slots + 1,), n, dtype=torch.long, device=h.device)
    token_of = token_of.scatter(0, slot_of.reshape(-1), choices // k)[:m_slots]
    choice_of = torch.full((m_slots + 1,), n * k, dtype=torch.long, device=h.device)
    choice_of = choice_of.scatter(0, slot_of.reshape(-1), choices)[:m_slots]

    xin = _RowGather.apply(x.to(cdt), token_of, slot_of).reshape(e, g * capacity, d)
    ex = mlp["experts"]
    if cfg.activation == "swiglu":
        f = ex["w2"].shape[1]
        gates = torch.bmm(xin, ex["w1"].to(cdt).reshape(e, d, 2 * f)).reshape(e, -1, 2, f)
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
    if "b2" in ex:
        out = out + ex["b2"].to(cdt)[:, None]

    picked = _RowGather.apply(out.reshape(m_slots, d), slot_of, choice_of)  # (N, k, D)
    weights = (r.gate * r.keep).reshape(n, k, 1)
    y = (weights * picked.float()).sum(dim=1)
    return y.to(h.dtype).reshape(b, t, d), r.aux.mean()
