"""Decoder-only transformer: init/forward over a dict of parameter tensors.

Counterpart of ``pretraining_llm_tpu/models/transformer.py`` for serving
and training (``loss_fn`` with the chunked, dense and fused CE heads;
document segments from ``doc_mask_token``). Parameters
keep the JAX tree's names and layouts — block parameters are
stacked with a leading n_layers dim (``blocks.attn.wqkv`` is (L, d, 3, H,
Dh)) — so ``models.bridge`` maps one tree onto the other leaf for leaf.

``forward`` covers three cases:
  - no cache (T tokens of self-attention);
  - a dense cache at any ``cache_index``: the call writes its K/V at slots
    cache_index..cache_index+T-1 (int8 codes + fp32 scales under
    ``kv_cache_dtype="int8"``), then attends as the JAX package's dense
    branches do: a prefill at index 0 over the block's own q/k/v
    (``attention_impl="flash"`` goes to the flash kernel); a chunk at a
    nonzero index (T > 1, flash) by ``blockwise_attention`` over the
    written cache, cut to the key tiles it can see; decode (T = 1, ragged
    rows, or naive attention) by masked attention over the whole cache.
    ``pad_offsets`` gives ragged rows their left-pad: logical positions
    ``slot - pad_offsets[i]``, pad slots masked;
  - paged: each row writes its T query tokens' K/V into its pool pages at
    slots seq..seq+T-1 (quantized for int8 pools), then attends over its
    pages. ``paged_attention_impl="kernel"`` routes as the JAX package
    does: int8 pools and ragged calls (``PagedInfo.q_lens``, T > 1: chunked
    prefill and prefix-cache suffixes) through the ragged kernel, the rest
    through the paged kernel; "gather" through the plain gather path.

Under an active mesh with a tensor axis (``parallel.sharding.
activation_mesh``) each rank holds its blocks of the Megatron layers
(``parallel/sharding.py``'s rules) and the layers issue the collectives
that GSPMD inserts for the JAX package (``parallel/tensor.py``):
column-parallel ``wqkv``/``wq``/``wkv`` give the rank its H/tp query heads
(and G/tp KV heads; where G does not divide tp, ``wkv`` is replicated and
the rank takes its heads' K/V), attention runs on those heads (the flash
kernels on the card), the row-parallel ``wo`` and ``w2`` products are
summed over the tensor ranks before ``bo``/``b2``; the embedding, the head
and its losses are vocabulary-parallel, and ``forward``'s logits are
gathered over the vocabulary. A cached call whose KV pool is replicated
(G not dividing tp) gathers the query heads and attends over the whole
pool, as JAX's replicated ``pallas_call`` does, then keeps its heads.

int8 serving weights (``models/quantize.py``) are dequantized at each use
site (``_weight``). A model with ``n_experts`` runs ``models/moe.py``'s MLP
in every block, and its forward can return the router's load-balance loss
(``return_aux``), which ``loss_fn`` adds to the training objective.

Matmuls run in ``compute_dtype`` and round their result to it, as the JAX
einsums with fp32 accumulation then ``astype(cdt)`` do; norms run in fp32;
the output head multiplies compute-dtype operands with fp32 accumulation
and returns fp32 logits. PyTorch runs eagerly, so the KV cache and the pools
are updated in place and returned.
"""

from __future__ import annotations

import warnings
from typing import Any, Dict, NamedTuple, Optional, Tuple, Union

import torch

from pretraining_llm_tpu_torch.config import ModelConfig
from pretraining_llm_tpu_torch.models import layers, moe
from pretraining_llm_tpu_torch.ops import remat
from pretraining_llm_tpu_torch.ops.attention import multihead_attention, naive_attention
from pretraining_llm_tpu_torch.ops.cuda_paged import paged_decode_attention, paged_kv_mask
from pretraining_llm_tpu_torch.ops.cuda_ragged import ragged_paged_attention
from pretraining_llm_tpu_torch.ops.flash_attention import blockwise_attention, flash_attention
from pretraining_llm_tpu_torch.ops.fused_ce import fused_cross_entropy
from pretraining_llm_tpu_torch.parallel.mesh import axis_size, coordinate
from pretraining_llm_tpu_torch.parallel.ring_attention import ring_supports_grouped
from pretraining_llm_tpu_torch.parallel import pipeline
from pretraining_llm_tpu_torch.parallel.sharding import current_mesh, rows_split, sequence_shards  # noqa: F401
from pretraining_llm_tpu_torch.parallel.tensor import (
    copy_to_group, gather_dim, gather_last, gather_rows, layer_group, sum_over_group, tensor_group, vocab_embed,
    vocab_label, vocab_lse,
)
from pretraining_llm_tpu_torch.parallel.ulysses import ulysses_supports_grouped
from pretraining_llm_tpu_torch.parallel.zigzag import zigzag_perm
from pretraining_llm_tpu_torch.utils.device import DeviceLike, resolve_device

Params = Dict[str, Any]
KVCache = Dict[str, Any]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {name!r}; expected one of {sorted(_DTYPES)}")
    return _DTYPES[name]


class PagedInfo(NamedTuple):
    """Batch-level paged-decode state shared by every layer.

    INVARIANT (caller-enforced): every row's seq_lens < max_blocks *
    block_size at the start of a step — a step WRITES slot seq_lens.
    Writes past capacity inside a multi-step window go to the reserved
    scratch block 0, never onto the row's last page."""

    block_tables: torch.Tensor  # (B, max_blocks) int32 — pool block ids per row
    seq_lens: torch.Tensor  # (B,) int32 — tokens already in the cache per row
    # (B,) int32 true query counts of a ragged multi-token call (chunked
    # prefill, prefix-cache suffixes); queries past a row's count are
    # padding. Only the kernel lane reads it: real queries' outputs are
    # the same with or without it.
    q_lens: Optional[torch.Tensor] = None


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def param_shapes(cfg: ModelConfig) -> Params:
    """The parameter tree's shapes — the same names and layouts as the JAX
    package's ``init_params``."""
    d, h, dh, f, v, t, nl = (
        cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff, cfg.vocab_size,
        cfg.context_length, cfg.n_layers,
    )
    g = cfg.kv_heads

    def norm() -> Params:
        p = {"scale": (d,)}
        if cfg.norm == "layernorm":
            p["bias"] = (d,)
        return p

    if g == h:
        attn: Params = {"wqkv": (d, 3, h, dh)}
        if cfg.qkv_bias:
            attn["bqkv"] = (3, h, dh)
    else:
        attn = {"wq": (d, h, dh), "wkv": (d, 2, g, dh)}
        if cfg.qkv_bias:
            attn["bq"] = (h, dh)
            attn["bkv"] = (2, g, dh)
    if cfg.use_output_proj:
        attn["wo"] = (h, dh, d)
        attn["bo"] = (d,)
    if cfg.n_experts:
        mlp: Params = moe.param_shapes(cfg)
    elif cfg.activation == "swiglu":
        mlp = {"w1": (d, 2, f), "w2": (f, d)}
        if cfg.mlp_bias:
            mlp["b1"] = (2, f)
            mlp["b2"] = (d,)
    else:
        mlp = {"w1": (d, f), "w2": (f, d)}
        if cfg.mlp_bias:
            mlp["b1"] = (f,)
            mlp["b2"] = (d,)
    block = {"ln1": norm(), "attn": attn, "ln2": norm(), "mlp": mlp}

    def stacked(tree: Params) -> Params:
        return {
            k: stacked(s) if isinstance(s, dict) else (nl,) + s
            for k, s in tree.items()
        }

    shapes: Params = {
        "tok_embed": {"embedding": (v, d)},
        "blocks": stacked(block),
        "final_norm": norm(),
    }
    if cfg.pos_embed == "learned":
        shapes["pos_embed"] = {"embedding": (t, d)}
    if not cfg.tie_embeddings:
        shapes["lm_head"] = {"kernel": (d, v)}
        if cfg.lm_head_bias:
            shapes["lm_head"]["bias"] = (v,)
    return shapes


def init_params(
    cfg: ModelConfig, generator: Union[torch.Generator, int], *,
    device: DeviceLike = None,
) -> Params:
    """GPT-2 style init: N(0, 0.02) everywhere (the MoE router and experts'
    w1 too), residual-output projections (wo, w2, the experts' w2 too)
    scaled by 1/sqrt(2*n_layers), zeros for biases, ones for norm scales.
    Values are drawn on the generator's device (an int seeds a CPU
    generator, so one seed gives the same weights on every device) and
    moved to ``device``."""
    dev = resolve_device(device)
    if isinstance(generator, int):
        generator = torch.Generator().manual_seed(generator)
    dtype = torch_dtype(cfg.param_dtype)
    std = 0.02
    resid_std = std / (2 * cfg.n_layers) ** 0.5

    def init(name: str, shape: Tuple[int, ...]) -> torch.Tensor:
        if name == "scale":
            x = torch.ones(shape)
        elif name.startswith("b"):  # every bias, and bqkv / bq / bkv / bo
            x = torch.zeros(shape)
        else:
            s = resid_std if name in ("wo", "w2") else std
            x = torch.randn(shape, generator=generator, device=generator.device) * s
        return x.to(device=dev, dtype=dtype)

    def fill(tree: Params) -> Params:
        return {
            k: fill(s) if isinstance(s, dict) else init(k, s)
            for k, s in tree.items()
        }

    return fill(param_shapes(cfg))


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------


def rank_kv_heads(cfg: ModelConfig) -> int:
    """The KV heads a rank's cache or pool holds: kv_heads/tp under an
    active tensor mesh where tp divides kv_heads, else all of them (JAX's
    head split of the pools, replicated where it does not divide)."""
    tp = tensor_group(current_mesh())
    if tp is not None and cfg.kv_heads % tp.size == 0:
        return cfg.kv_heads // tp.size
    return cfg.kv_heads


def _kv_fields(cfg: ModelConfig, shape: Tuple[int, ...], names: Tuple[str, ...],
               dtype: Any, scale_dtype: Any, what: str) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """{name: (shape, dtype)} of a cache's K/V fields, plus per-(slot, head)
    scale fields when ``kv_cache_dtype='int8'``."""
    k, v, ks, vs = names
    if cfg.kv_cache_dtype == "int8":
        if dtype is not None:
            raise ValueError(f"{what}(dtype={dtype!r}) conflicts with kv_cache_dtype='int8'")
        sdt = torch_dtype(scale_dtype) if isinstance(scale_dtype, str) else (scale_dtype or torch.float32)
        if sdt not in (torch.float32, torch.bfloat16):
            raise ValueError(f"int8 scale_dtype must be float32 or bfloat16, got {sdt}")
        sshape = shape[:-1] + (1,)
        return {k: (shape, torch.int8), v: (shape, torch.int8), ks: (sshape, sdt), vs: (sshape, sdt)}
    if scale_dtype is not None:
        raise ValueError(
            f"{what}(scale_dtype={scale_dtype!r}) needs kv_cache_dtype='int8' "
            "(exact pools carry no scale pages)"
        )
    dt = torch_dtype(dtype) if isinstance(dtype, str) else (dtype or torch_dtype(cfg.compute_dtype))
    return {k: (shape, dt), v: (shape, dt)}


def make_kv_cache(
    cfg: ModelConfig, batch_size: int, max_length: int, dtype: Any = None, *,
    device: DeviceLike = None,
) -> KVCache:
    """Dense cache {'k', 'v'}: (L, B, Tmax, kv_heads, Dh), plus
    {'k_scale', 'v_scale'} (L, B, Tmax, kv_heads, 1) fp32 when
    ``kv_cache_dtype='int8'`` (then k/v hold int8 codes). ``dtype`` (a
    torch dtype or its name) overrides the compute dtype of an exact
    cache. The port keeps the stacked layout for either
    ``decode_cache_layout``: the layouts hold the same values. Under an
    active tensor mesh the cache holds the rank's heads
    (``rank_kv_heads``)."""
    if max_length > cfg.context_length:
        raise ValueError(
            f"kv cache max_length={max_length} exceeds context_length={cfg.context_length}"
        )
    shape = (cfg.n_layers, batch_size, max_length, rank_kv_heads(cfg), cfg.head_dim)
    fields = _kv_fields(cfg, shape, ("k", "v", "k_scale", "v_scale"), dtype, None, "make_kv_cache")
    dev = resolve_device(device)
    return {name: torch.zeros(s, dtype=dt, device=dev) for name, (s, dt) in fields.items()}


def make_paged_kv_pool(
    cfg: ModelConfig, n_blocks: int, block_size: int, dtype: Any = None, *,
    scale_dtype: Any = None, device: DeviceLike = None,
) -> KVCache:
    """Block pools for paged serving: {'layers': [{'k_pool', 'v_pool'}, ...]}
    with one (n_blocks, block_size, kv_heads, Dh) pool per layer, updated in
    place. Block 0 is reserved as the scratch target of idle rows and
    overshoot writes; allocators hand out ids from 1.

    With ``kv_cache_dtype='int8'`` the pools hold int8 codes and each layer
    also has {'k_scale_pool', 'v_scale_pool'} (n_blocks, block_size,
    kv_heads, 1) of ``scale_dtype``: fp32 by default, bf16 for
    ``quantize='int8-kv'`` serving, where a slot takes Dh + 2 bytes per
    head against 2 * Dh for bf16 (about 1.94x the blocks at Dh 64).
    Under an active tensor mesh the pools hold the rank's heads
    (``rank_kv_heads``)."""
    if n_blocks < 2:
        raise ValueError("need n_blocks >= 2 (block 0 is the idle scratch)")
    if block_size % 8:
        raise ValueError(f"block_size must be a multiple of 8, got {block_size}")
    shape = (n_blocks, block_size, rank_kv_heads(cfg), cfg.head_dim)
    fields = _kv_fields(
        cfg, shape, ("k_pool", "v_pool", "k_scale_pool", "v_scale_pool"), dtype, scale_dtype,
        "make_paged_kv_pool",
    )
    dev = resolve_device(device)
    return {
        "layers": [
            {name: torch.zeros(s, dtype=dt, device=dev) for name, (s, dt) in fields.items()}
            for _ in range(cfg.n_layers)
        ]
    }


def _kv_quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 per (token, head) over the channel dim: (codes, fp32
    amax scale)."""
    x32 = x.float()
    scale = x32.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8)
    return torch.round(x32 / scale * 127.0).to(torch.int8), scale


def _kv_dequantize(q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """codes * (f32(scale) / 127) in fp32, then ``dtype``. The scale is
    upcast first, so bf16 scale pages multiply in fp32 too."""
    return (q.float() * (scale.float() * (1.0 / 127.0))).to(dtype)


def _is_pool_cache(kv_cache: Optional[KVCache]) -> bool:
    return kv_cache is not None and "layers" in kv_cache and "k_pool" in kv_cache["layers"][0]


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _weight(sub: Params, name: str, cdt: torch.dtype) -> torch.Tensor:
    """A matmul weight in compute dtype: the single dequant point of int8
    serving weights (an int8 leaf and its ``{name}_scale`` fp32 sibling),
    one fp32 multiply, then the same cast the float path takes."""
    w = sub[name]
    if w.dtype == torch.int8:
        return (w.float() * sub[name + "_scale"]).to(cdt)
    return w.to(cdt)


def _mm(x: torch.Tensor, w: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    """x (..., K) @ w (K, ...) in compute dtype; w's trailing dims flatten."""
    k = w.shape[0]
    out = x.to(cdt) @ w.reshape(k, -1)
    return out.reshape(x.shape[:-1] + w.shape[1:])


def _positions_of_rows(seq_lens: torch.Tensor, t: int, limit: int) -> torch.Tensor:
    """(B, T) logical positions seq + i of each row's query tokens, clipped
    to the position tables (overshoot rows hold scratch garbage by
    contract; JAX gathers clamp out-of-range indices the same way)."""
    pos = seq_lens.long()[:, None] + torch.arange(t, device=seq_lens.device)[None, :]
    return pos.clamp(0, limit - 1)


def _logical_positions(positions: torch.Tensor, pad_offsets: torch.Tensor) -> torch.Tensor:
    """(B, T) logical positions of left-padded rows: slot - pad_offsets[i],
    pad slots clipped to 0 (their K/V is masked out of every real query)."""
    return (positions[None, :] - pad_offsets.long()[:, None]).clamp_min(0)


def _attention_block(
    blk: Params, x: torch.Tensor, cfg: ModelConfig,
    rope: Optional[Tuple[torch.Tensor, torch.Tensor]], positions: torch.Tensor,
    kv: Optional[Params], paged: Optional[PagedInfo],
    segments: Optional[torch.Tensor] = None, cache_index: int = 0,
    pad_offsets: Optional[torch.Tensor] = None, zigzag: bool = False,
) -> torch.Tensor:
    """Pre-LN attention sub-block: x + attn(ln1(x)). ``kv`` (one layer's
    dense cache or pools) is written in place. ``segments`` (B, T) int32
    document ids confine the uncached self-attention to each document.
    ``pad_offsets`` (B,) left-pads of ragged rows in a dense cache: RoPE
    takes the rows' logical positions, causality and writes the slots.
    ``zigzag`` declares x the rank's chunks of the zigzag layout (ring
    attention)."""
    cdt = torch_dtype(cfg.compute_dtype)
    b, t, _ = x.shape
    tp = tensor_group(current_mesh())
    h = copy_to_group(layers.apply_norm(cfg.norm, blk["ln1"], x, cfg.norm_eps), tp)
    attn = blk["attn"]
    # The "qkv" remat tag: a policy that keeps it keeps these products.
    if "wqkv" in attn:
        wqkv = _weight(attn, "wqkv", cdt)
        with remat.site("qkv"):
            qkv = _mm(h, wqkv, cdt)  # (B, T, 3, H, Dh)
        if "bqkv" in attn:
            qkv = qkv + attn["bqkv"].to(cdt)
        q, k, v = qkv.unbind(2)
    else:
        wq, wkv = _weight(attn, "wq", cdt), _weight(attn, "wkv", cdt)
        with remat.site("qkv"):
            q = _mm(h, wq, cdt)  # (B, T, H, Dh)
            kvp = _mm(h, wkv, cdt)  # (B, T, 2, G, Dh)
        if "bq" in attn:
            q = q + attn["bq"].to(cdt)
            kvp = kvp + attn["bkv"].to(cdt)
        k, v = kvp.unbind(2)

    if rope is not None:
        cos, sin = rope
        if paged is not None:
            rope_pos = _positions_of_rows(paged.seq_lens, t, cfg.context_length)
        elif pad_offsets is not None:
            rope_pos = _logical_positions(positions, pad_offsets)
        else:
            rope_pos = positions
        q = layers.apply_rope(q, cos, sin, rope_pos)
        k = layers.apply_rope(k, cos, sin, rope_pos)

    window = cfg.sliding_window
    # G not dividing tp: ``wkv`` is replicated and k/v hold all G heads.
    kv_replicated = tp is not None and cfg.kv_heads % tp.size != 0
    hl = q.shape[2]
    if kv is not None and kv_replicated:
        # The pool or cache holds every KV head on every rank: attend with
        # all query heads (gathered), keep the rank's.
        q = gather_dim(q, 2, tp)
    elif kv_replicated:
        k, v = _local_kv_heads(k, v, cfg, tp, hl)
    if kv is not None and "k_pool" in kv:
        out = _paged_attention(q, k, v, kv, paged, cfg, cdt)
    elif kv is not None:
        out = _dense_cached_attention(q, k, v, kv, cfg, cdt, cache_index, positions, pad_offsets)
    elif cfg.attention_impl == "flash":
        out = flash_attention(q, k, v, window=window, block_q=cfg.flash_block_q,
                              block_kv=cfg.flash_block_kv, segments=segments)
    elif cfg.attention_impl in ("ring", "ulysses"):
        supports = ring_supports_grouped if cfg.attention_impl == "ring" else ulysses_supports_grouped
        if not supports(current_mesh(), cfg.n_heads, cfg.kv_heads):
            rep = q.shape[2] // k.shape[2]
            k, v = k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2)
        out = multihead_attention(
            q, k, v, impl=cfg.attention_impl, block_q=cfg.flash_block_q, block_kv=cfg.flash_block_kv,
            ring_layout="zigzag" if zigzag else "contiguous", segments=segments, window=window,
        )
    else:
        out = naive_attention(q, k, v, causal=True, window=window, segments=segments)

    if kv is not None and kv_replicated:
        out = out[:, :, tp.index * hl:(tp.index + 1) * hl]
    if cfg.use_output_proj:
        out = _mm(out.reshape(b, t, -1), _weight(attn, "wo", cdt).reshape(-1, cfg.d_model), cdt)
        out = _row_parallel_sum(out, tp)
        out = out + attn["bo"].to(cdt)
    else:
        out = gather_last(out.reshape(b, t, hl * cfg.head_dim), tp)
    return x + out.to(x.dtype)


def _row_parallel_sum(out: torch.Tensor, tp: Any) -> torch.Tensor:
    """The sum over the tensor ranks of a row-parallel product's partial
    outputs, in fp32, rounded once to their dtype."""
    if tp is None:
        return out
    return sum_over_group(out.float(), tp).to(out.dtype)


def _local_kv_heads(k: torch.Tensor, v: torch.Tensor, cfg: ModelConfig, tp: Any,
                    hl: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The rank's per-query-head K/V from all G KV heads, when G does not
    divide tp: its query heads do not map onto whole groups, so each takes
    its group's head (a copy per query head)."""
    rep = cfg.n_heads // cfg.kv_heads
    heads = torch.div(tp.index * hl + torch.arange(hl, device=k.device), rep, rounding_mode="floor")
    return k.index_select(2, heads), v.index_select(2, heads)


def _materialize_cache(kv: Params, lo: int, hi: int, cdt: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """(k, v) of cache slots [lo, hi) in compute dtype, int8 codes
    dequantized: the one read point of every dense cached attention (the
    JAX package's ``_materialize_cache``)."""
    if "k_scale" in kv:
        return (_kv_dequantize(kv["k"][:, lo:hi], kv["k_scale"][:, lo:hi], cdt),
                _kv_dequantize(kv["v"][:, lo:hi], kv["v_scale"][:, lo:hi], cdt))
    return kv["k"][:, lo:hi].to(cdt), kv["v"][:, lo:hi].to(cdt)


def _dense_cached_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv: Params, cfg: ModelConfig,
    cdt: torch.dtype, cache_index: int, positions: torch.Tensor,
    pad_offsets: Optional[torch.Tensor],
) -> torch.Tensor:
    """Write the call's K/V at slots [cache_index, cache_index + T) of one
    layer's dense cache (int8: codes and scales), then attend as the JAX
    package's dense branches (``transformer.py:455-571``) do:
      - T > 1 at index 0, flash, no ragged rows: causal flash attention
        over the block's own q/k/v (exactly attention over the written
        prefix [0, T), with the unquantized local k/v);
      - T > 1 at a nonzero index, flash, no ragged rows (chunked
        prefill): ``blockwise_attention`` over cache slots [k_lo, hi),
        ``hi`` the frontier rounded up to the KV tile, ``k_lo`` the
        window's lower cut rounded down to it, queries placed at
        ``cache_index``;
      - otherwise (decode, ragged rows, naive attention): masked attention
        over the whole cache, slots < cache_index + T and, for ragged
        rows, slots >= pad_offsets[i]."""
    b, t = q.shape[:2]
    end = cache_index + t
    if "k_scale" in kv:
        for name, val in (("k", k), ("v", v)):
            kv[name][:, cache_index:end], kv[name + "_scale"][:, cache_index:end] = _kv_quantize(val)
    else:
        kv["k"][:, cache_index:end] = k
        kv["v"][:, cache_index:end] = v
    window = cfg.sliding_window
    tmax = kv["k"].shape[1]
    if t > 1 and pad_offsets is None and cfg.attention_impl == "flash":
        if cache_index == 0:
            return flash_attention(q, k, v, window=window, block_q=cfg.flash_block_q,
                                   block_kv=cfg.flash_block_kv)
        # Keys past the frontier's tile and below the window's tile see no
        # query: slice them off (tile-aligned, so the block stays JAX's).
        tile = cfg.flash_block_kv or 512
        hi = min(tmax, -(-end // tile) * tile)
        k_lo = max(0, (cache_index - window + 1) // tile * tile) if window else 0
        ck, cv = _materialize_cache(kv, k_lo, hi, cdt)
        return blockwise_attention(
            q, ck, cv, causal=True, block_q=cfg.flash_block_q, block_kv=cfg.flash_block_kv,
            q_offset=cache_index, k_offset=k_lo, window=window,
        )
    kv_pos = torch.arange(tmax, device=q.device)
    kv_mask = (kv_pos < end)[None, :].expand(b, tmax)
    if pad_offsets is not None:
        kv_mask = kv_mask & (kv_pos[None, :] >= pad_offsets.long()[:, None])
    ck, cv = _materialize_cache(kv, 0, tmax, cdt)
    return naive_attention(q, ck, cv, q_positions=positions, kv_positions=kv_pos, kv_mask=kv_mask,
                           window=window)


def _paged_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv: Params,
    paged: Optional[PagedInfo], cfg: ModelConfig, cdt: torch.dtype,
) -> torch.Tensor:
    """Write token i of each row at its logical slot seq + i through the
    row's block table (int8 pools: quantized codes and scales), then attend
    over the row's pages, routed as ``pretraining_llm_tpu/models/
    transformer.py`` routes it:
      - "kernel", int8 pools: the ragged kernel for every query shape
        (q_lens = T unless a ragged call passes its own);
      - "kernel", exact pools, T > 1 with ``q_lens``: the ragged kernel;
      - "kernel", otherwise: the paged kernel;
      - "gather": gather the pages (dequantized after the gather), masked
        attention; ``q_lens`` is ignored, pad queries are computed and
        discarded."""
    if paged is None:
        raise ValueError("a paged kv pool requires forward(..., paged=PagedInfo)")
    b, t = q.shape[:2]
    k_pool, v_pool = kv["k_pool"], kv["v_pool"]
    block_size = k_pool.shape[1]
    tables, seq = paged.block_tables, paged.seq_lens
    capacity = tables.shape[1] * block_size
    pos = seq.long()[:, None] + torch.arange(t, device=q.device)[None, :]  # (B, T)
    # Overshoot guard: inside a multi-step window a row can pass its table
    # capacity; such writes go to the reserved scratch block 0 instead of
    # clamping onto the row's last page.
    in_range = pos < capacity
    pos_c = pos.clamp(max=capacity - 1)
    page = tables.long().gather(1, pos_c // block_size)
    blk_ids = torch.where(in_range, page, torch.zeros_like(page))
    slots = torch.where(in_range, pos_c % block_size, torch.zeros_like(pos_c))
    quantized = "k_scale_pool" in kv
    if quantized:
        ks_pool, vs_pool = kv["k_scale_pool"], kv["v_scale_pool"]
        k_q, k_sc = _kv_quantize(k)
        v_q, v_sc = _kv_quantize(v)
        k_pool[blk_ids, slots] = k_q
        v_pool[blk_ids, slots] = v_q
        ks_pool[blk_ids, slots] = k_sc.to(ks_pool.dtype)
        vs_pool[blk_ids, slots] = v_sc.to(vs_pool.dtype)
    else:
        k_pool[blk_ids, slots] = k.to(k_pool.dtype)
        v_pool[blk_ids, slots] = v.to(v_pool.dtype)

    window = cfg.sliding_window
    qc = q.to(cdt).contiguous()
    ragged_kw = dict(window=window, kv_splits=cfg.ragged_kv_splits or None, amla=cfg.ragged_amla)
    if cfg.paged_attention_impl == "kernel" and quantized:
        q_lens = paged.q_lens
        if t == 1 or q_lens is None:
            q_lens = torch.full((b,), t, dtype=torch.int32, device=q.device)
        return ragged_paged_attention(
            qc, k_pool, v_pool, tables, seq, q_lens, k_scale=ks_pool, v_scale=vs_pool,
            **ragged_kw,
        )
    if cfg.paged_attention_impl == "kernel":
        if t > 1 and paged.q_lens is not None:
            return ragged_paged_attention(
                qc, k_pool.to(cdt), v_pool.to(cdt), tables, seq, paged.q_lens, **ragged_kw
            )
        out = paged_decode_attention(
            qc[:, 0] if t == 1 else qc, k_pool.to(cdt), v_pool.to(cdt), tables, seq,
            window=window,
        )
        return out[:, None] if t == 1 else out
    kv_len = tables.shape[1] * block_size
    rows = tables.long()

    def gather(pool: torch.Tensor) -> torch.Tensor:
        return pool[rows].reshape((b, kv_len) + tuple(pool.shape[2:]))

    if quantized:
        ck = _kv_dequantize(gather(k_pool), gather(ks_pool), cdt)
        cv = _kv_dequantize(gather(v_pool), gather(vs_pool), cdt)
    else:
        ck, cv = gather(k_pool).to(cdt), gather(v_pool).to(cdt)
    return naive_attention(
        q, ck, cv, causal=False, kv_mask=paged_kv_mask(seq, t, kv_len, window)
    )


def _mlp_block(blk: Params, x: torch.Tensor, cfg: ModelConfig, decode: bool = False,
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Pre-LN MLP sub-block: (x + mlp(ln2(x)), the MoE router's aux loss, or
    None for a dense MLP). ``decode`` routes a MoE call without capacity
    (``moe.moe_mlp``)."""
    cdt = torch_dtype(cfg.compute_dtype)
    h = layers.apply_norm(cfg.norm, blk["ln2"], x, cfg.norm_eps).to(cdt)
    mlp = blk["mlp"]
    if cfg.n_experts:
        out, aux = moe.moe_mlp(mlp, h, cfg, decode=decode)
        return x + out.to(x.dtype), aux
    tp = tensor_group(current_mesh())
    h = copy_to_group(h, tp)
    if cfg.activation == "swiglu":
        gates = _mm(h, _weight(mlp, "w1", cdt), cdt)  # (B, T, 2, f)
        if "b1" in mlp:
            gates = gates + mlp["b1"].to(cdt)
        act = torch.nn.functional.silu(gates[..., 0, :])
        with remat.site("mlp_hidden"):  # the remat tag on the activation's last op
            hidden = act * gates[..., 1, :]
    else:
        hidden = _mm(h, _weight(mlp, "w1", cdt), cdt)
        if "b1" in mlp:
            hidden = hidden + mlp["b1"].to(cdt)
        with remat.site("mlp_hidden"):
            hidden = layers.activation_fn(cfg.activation, hidden)
    out = _row_parallel_sum(_mm(hidden, _weight(mlp, "w2", cdt), cdt), tp)
    if "b2" in mlp:
        out = out + mlp["b2"].to(cdt)
    return x + out.to(x.dtype), None


def _layer(tree: Union[Params, list], i: int) -> Params:
    """Layer i's parameters: views into the stacked block tensors, or entry
    i of a per-layer list (``training.train_step`` hands the backward one
    leaf per layer, so no layer's gradient is a full stacked tensor)."""
    if isinstance(tree, list):
        return tree[i]
    return {k: _layer(s, i) if isinstance(s, dict) else s[i] for k, s in tree.items()}


def _layer_count(tree: Union[Params, list]) -> int:
    """The layers of a per-layer list or of stacked block tensors."""
    if isinstance(tree, list):
        return len(tree)
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.shape[0]


def use_pipeline(cfg: ModelConfig, mesh: Any, kv_cache: Optional[KVCache] = None) -> bool:
    """JAX's rule for the pipelined layer path: an uncached call of a
    ``pipeline_stages`` > 1 model under a mesh whose pipe axis is above 1."""
    return kv_cache is None and cfg.pipeline_stages > 1 and mesh is not None and axis_size(mesh, "pipe") > 1


def _stage_layers(blocks: Union[Params, list], cfg: ModelConfig, mesh: Any, baked: bool) -> list:
    """This pipe rank's layers in the order its stage runs them: the
    rank-major block of ``pipeline.interleave_layout``. ``blocks`` holds
    the rank's ``L / S`` layers, or all L (depth-major, or rank-major when
    ``baked``), of which the rank takes its own."""
    n = _layer_count(blocks)
    s, v, r = axis_size(mesh, "pipe"), cfg.pipeline_interleave, coordinate(mesh)["pipe"]
    if n == cfg.n_layers:
        if baked or v == 1:
            idx = range(r * n // s, (r + 1) * n // s)
        else:
            idx = [i for lo, hi in pipeline.depth_chunks(r, n, s, v) for i in range(lo, hi)]
    elif n * s == cfg.n_layers:
        if v > 1 and not baked:
            raise ValueError(
                f"a pipe rank's {n} layers of an interleaved pipeline (pipeline_interleave={v}) must be in the "
                "baked rank-major layout (blocks_baked=True; train_step.shard_train_state bakes it)")
        idx = range(n)
    else:
        raise ValueError(f"params['blocks'] holds {n} layers: neither n_layers={cfg.n_layers} nor this pipe "
                         f"rank's n_layers / {s}")
    return [_layer(blocks, i) for i in idx]


def _pipeline_row_map(b: int, cfg: ModelConfig, mesh: Any) -> Optional[Tuple[torch.Tensor, torch.Tensor, Any]]:
    """(the global rows this rank holds inside the pipeline, where each of
    its own rows lies among the group's pipeline rows, its data x fsdp
    group) where a microbatch's rows matter (a MoE model: its routing
    groups and capacity are the global microbatch's) and the ranks split
    the rows of more than one microbatch; else None (each rank's
    contiguous rows serve: a dense layer computes every row alone)."""
    grp = layer_group(mesh, ("data", "fsdp"))
    n = cfg.pipeline_microbatches
    if not cfg.n_experts or grp is None or not rows_split() or n == 1:
        return None
    held = torch.cat([pipeline.microbatch_rows(b, n, grp.size, k) for k in range(grp.size)])
    return held[grp.index * b:(grp.index + 1) * b], torch.argsort(held)[grp.index * b:(grp.index + 1) * b], grp


def _take_rows(a: torch.Tensor, rows: Tuple[torch.Tensor, torch.Tensor, Any]) -> torch.Tensor:
    """This rank's pipeline rows of a (B, ...) integer batch (the group's
    rows gathered, then the rank's picked)."""
    index, _, grp = rows
    return gather_dim(a.contiguous(), 0, grp)[index.to(a.device)]


def _restore_rows(out: torch.Tensor, rows: Tuple[torch.Tensor, torch.Tensor, Any]) -> torch.Tensor:
    """The inverse of ``_take_rows`` on an output: the rank's own rows, from
    the group's pipeline rows gathered (the backward sums the gradient over
    the group and keeps the rank's pipeline rows)."""
    _, inverse, grp = rows
    return gather_rows(out, grp)[inverse.to(out.device)]


def forward(
    params: Params,
    tokens: torch.Tensor,
    cfg: ModelConfig,
    *,
    positions: Optional[torch.Tensor] = None,
    kv_cache: Optional[KVCache] = None,
    cache_index: Optional[int] = None,
    paged: Optional[PagedInfo] = None,
    return_pre_logits: bool = False,
    pad_offsets: Optional[torch.Tensor] = None,
    return_hidden: bool = False,
    return_aux: bool = False,
    zigzag: bool = False,
    blocks_baked: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """tokens (B, T) -> (logits (B, T, V) fp32, kv_cache), then, in this
    order, the extra values asked for: with ``return_hidden=True`` the
    intermediate activations ``{"block_outputs": (L, B, T, D), one layer's
    output each (None in a cached call), "final_hidden": (B, T, D), the
    final norm's output}``; with ``return_aux=True`` the MoE router's
    load-balance loss summed over layers (fp32 scalar; 0 for a dense model).

    ``return_pre_logits=True`` returns the final-norm hidden states (B, T,
    D) in place of the logits: the loss path's CE head computes logits
    itself (``loss_fn``). A MoE model routes with capacity, in groups,
    except in a cached call of one token per row (decode), which routes
    without capacity, as the JAX package does.

    ``kv_cache`` from ``make_kv_cache`` takes the T tokens at slots
    ``cache_index`` (an int, default 0) .. cache_index+T-1: the prefill at
    0, a chunk or a decode step after it. ``pad_offsets`` (B,) int makes
    the rows ragged (decode only, with a dense cache): row i is left-padded
    by pad_offsets[i] dead slots, so its token at slot s has logical
    position s - pad_offsets[i] (learned and RoPE positions), while writes
    and causality stay on slots and the pad slots are masked. A pool from
    ``make_paged_kv_pool`` with ``paged`` is paged attention: T query
    tokens per row at slots seq..seq+T-1, of which ``paged.q_lens`` (when
    given) are real. Caches are updated in place and returned.

    Under a mesh with sequence-parallel attention (``loss_fn``), tokens are
    the rank's sequence chunk and ``positions`` (T,) their global
    positions; ``zigzag=True`` declares the chunk-pair layout of
    ``parallel.zigzag``.

    With ``pipeline_stages`` > 1 under a mesh whose pipe axis is above 1
    (``use_pipeline``; uncached calls only, as in JAX) the layers run as
    this rank's stage of ``parallel.pipeline``: ``params["blocks"]`` is the
    rank's ``L / S`` layers (or the full stack, of which it takes them),
    in the rank-major order of ``pipeline.interleave_layout`` when
    ``blocks_baked`` (the train state's, required for V > 1 on the rank's
    layers). The final norm then runs on the rank's T / S columns:
    ``return_pre_logits`` returns them (B, T / S, D), for a MoE model
    with split rows in the rows of ``pipeline.microbatch_rows``
    (``pipeline_targets`` gives ``loss_fn`` the matching targets); the
    logits are gathered back to the rank's rows, every column. Elsewhere
    a ``pipeline_stages`` > 1 config runs the plain layer loop."""
    cdt = torch_dtype(cfg.compute_dtype)
    mesh = current_mesh()
    piped = use_pipeline(cfg, mesh, kv_cache)
    if piped and return_hidden:
        raise ValueError("return_hidden is not supported with pipeline parallelism")
    if blocks_baked and not piped:
        raise ValueError(
            "blocks_baked=True but the pipelined path is inactive (no pipe "
            "mesh installed, or pipeline_stages<=1): a rank-major baked "
            "layer stack would be scanned in the wrong depth order. "
            "De-interleave with parallel.pipeline.deinterleave_layout first."
        )
    rows = _pipeline_row_map(tokens.shape[0], cfg, mesh) if piped else None
    if rows is not None:
        tokens = _take_rows(tokens, rows)
    b, t = tokens.shape
    device = tokens.device
    if pad_offsets is not None and kv_cache is None:
        raise ValueError(
            "pad_offsets (ragged left-padded rows) is a cached-decode "
            "layout; training/eval calls must not pass it"
        )
    if paged is not None:
        if not _is_pool_cache(kv_cache):
            raise ValueError("paged=PagedInfo requires a pool-layout kv_cache (make_paged_kv_pool)")
        if pad_offsets is not None:
            raise ValueError(
                "pad_offsets is the contiguous ragged layout; paged rows "
                "are ragged natively via seq_lens"
            )
    elif _is_pool_cache(kv_cache):
        raise ValueError("a pool-layout kv_cache requires forward(..., paged=PagedInfo)")
    cache_index = int(cache_index or 0)
    if positions is None:
        positions = cache_index + torch.arange(t, device=device)

    # Packed-document masking, as the JAX package derives it in-model: token
    # i belongs to document #(separators strictly before i), so a separator
    # is the last token of its document (an exclusive cumsum). Training and
    # eval only: a cached forward refuses it.
    segments = None
    if cfg.doc_mask_token >= 0:
        if kv_cache is not None:
            raise ValueError(
                "doc_mask_token is a training/eval feature; cached decode "
                "must run with doc masking disabled"
            )
        is_sep = (tokens == cfg.doc_mask_token).to(torch.int32)
        segments = (torch.cumsum(is_sep, dim=1, dtype=torch.int32) - is_sep).contiguous()

    tp = tensor_group(current_mesh())
    x = vocab_embed(params["tok_embed"]["embedding"], tokens, tp, cdt)
    rope = None
    if cfg.pos_embed == "learned":
        pos_table = params["pos_embed"]["embedding"]
        if paged is not None:
            ppos = _positions_of_rows(paged.seq_lens, t, cfg.context_length)
            x = x + pos_table[ppos].to(cdt)
        elif pad_offsets is not None:
            x = x + pos_table[_logical_positions(positions, pad_offsets)].to(cdt)
        else:
            x = x + pos_table[positions].to(cdt)[None]
    else:
        rope = layers.rope_table(cfg.context_length, cfg.head_dim, cfg.rope_theta, device)

    def layer_body(x: torch.Tensor, blk: Params) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        x = _attention_block(blk, x, cfg, rope, positions, None, None, segments, zigzag=zigzag)
        return _mlp_block(blk, x, cfg)

    aux_total = None
    if piped:
        batch_shards = axis_size(mesh, "data") * axis_size(mesh, "fsdp") if rows_split() else 1
        x, aux_total = pipeline.pipeline_apply(
            _stage_layers(params["blocks"], cfg, mesh, blocks_baked), x, mesh, lambda blk, h: layer_body(h, blk),
            n_micro=cfg.pipeline_microbatches, remat=cfg.remat, interleave=cfg.pipeline_interleave,
            batch_shards=batch_shards)
    # Training wraps each layer in the remat policy; cached and no-grad
    # calls (serving, generate, eval) run the layers as they are.
    body = remat.checkpoint_wrap(layer_body, cfg.remat) if torch.is_grad_enabled() else layer_body
    block_outputs: Optional[list] = [] if return_hidden and kv_cache is None else None
    for i in range(0 if piped else cfg.n_layers):
        blk = _layer(params["blocks"], i)
        if kv_cache is None:
            x, aux = body(x, blk)
        else:
            layer_kv = (kv_cache["layers"][i] if paged is not None
                        else {name: buf[i] for name, buf in kv_cache.items()})
            x = _attention_block(blk, x, cfg, rope, positions, layer_kv, paged, segments,
                                 cache_index, pad_offsets)
            x, aux = _mlp_block(blk, x, cfg, decode=t == 1)
        if aux is not None:
            aux_total = aux if aux_total is None else aux_total + aux
        if block_outputs is not None:
            block_outputs.append(x)

    x = layers.apply_norm(cfg.norm, params["final_norm"], x, cfg.norm_eps)
    if return_pre_logits:
        out = x
    else:
        w_out, bias = _lm_head_weights(params, cfg)
        out = gather_last(_head_logits32(copy_to_group(x, tp), w_out.to(cdt), bias, cdt), tp)
        if piped:
            out = pipeline.gather_columns(out, mesh)
            if rows is not None:
                out = _restore_rows(out, rows)
    extras: Tuple[Any, ...] = ()
    if return_hidden:
        stacked = None if block_outputs is None else torch.stack(block_outputs)
        extras += ({"block_outputs": stacked, "final_hidden": x},)
    if return_aux:
        if aux_total is None:
            aux_total = torch.zeros((), dtype=torch.float32, device=device)
        extras += (aux_total,)
    return (out, kv_cache) + extras


def _lm_head_weights(params: Params, cfg: ModelConfig) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(w_out (D, V), bias (V,) or None): the one definition of the output
    head, shared by ``forward`` and ``loss_fn``."""
    if cfg.tie_embeddings:
        return params["tok_embed"]["embedding"].T, None
    head = params["lm_head"]
    return head["kernel"], head.get("bias")


# ---------------------------------------------------------------------------
# Loss: the chunked and dense cross-entropy heads
# ---------------------------------------------------------------------------


def _head_logits32(
    xc: torch.Tensor, wc: torch.Tensor, bias: Optional[torch.Tensor], cdt: torch.dtype,
) -> torch.Tensor:
    """Head logits, the one formula of both CE heads and ``forward``:
    compute-dtype operands, fp32 products (the values of JAX's
    ``preferred_element_type=f32`` einsum), fp32 bias add. ``wc`` is
    already in the compute dtype."""
    logits = xc.to(cdt).float() @ wc.float()
    if bias is not None:
        logits = logits + bias.float()
    return logits


def _subtract_onehot(p: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """p - onehot(targets) in the iota-compare form (no scatter), as the
    JAX package writes it. Targets must lie in [0, V): an out-of-range id is
    a no-op here, so ignored positions need a loss mask, never a sentinel."""
    cols = torch.arange(p.shape[1], device=p.device)
    return p - (cols[None, :] == targets[:, None]).to(p.dtype)


class _LseSavedCE(torch.autograd.Function):
    """Sum of per-token CE over token chunks (the JAX ``_lse_saved_ce``
    custom VJP): the forward keeps each chunk's logits only transiently and
    saves the (S,) logsumexp; the backward recomputes a chunk's logits and
    forms softmax = exp(logits - lse) in one pass. z-loss adds z * lse^2
    per token (its gradient scales p by 1 + 2 z lse). With a tensor group
    ``grp`` the head is vocabulary-parallel: ``w_out`` and ``bias`` are the
    rank's V/tp columns, ``ts_`` the targets shifted into them, and the lse
    and label logit combine over the group (``parallel.tensor``); the
    input gradient is the rank's part."""

    @staticmethod
    def forward(ctx, xs, w_out, bias, ts_, cdt, z, grp=None):
        wc = w_out.to(cdt)
        total = torch.zeros((), dtype=torch.float32, device=xs.device)
        lses = []
        for xc, tc in zip(xs, ts_):
            logits = _head_logits32(xc, wc, bias, cdt)
            lse = vocab_lse(logits, grp)
            label = vocab_label(logits, tc, grp)
            chunk = (lse - label).sum()
            if z:
                chunk = chunk + z * lse.square().sum()
            total = total + chunk
            lses.append(lse)
        ctx.save_for_backward(xs, w_out, bias, ts_, torch.stack(lses))
        ctx.cdt, ctx.z = cdt, z
        return total

    @staticmethod
    def backward(ctx, g):
        xs, w_out, bias, ts_, lses = ctx.saved_tensors
        cdt, z = ctx.cdt, ctx.z
        wc = w_out.to(cdt)
        w32 = wc.float()
        dw = torch.zeros(w_out.shape, dtype=torch.float32, device=xs.device)
        db = None if bias is None else torch.zeros(bias.shape, dtype=torch.float32, device=xs.device)
        dxs = []
        for xc, tc, lse in zip(xs, ts_, lses):
            logits = _head_logits32(xc, wc, bias, cdt)
            p = torch.exp(logits - lse[:, None])
            if z:
                p = p * (1.0 + 2.0 * z * lse[:, None])
            dlogits = _subtract_onehot(p, tc) * g
            dxs.append((dlogits @ w32.T).to(xs.dtype))
            dw = dw + xc.to(cdt).float().T @ dlogits
            if db is not None:
                db = db + dlogits.sum(0)
        return (
            torch.stack(dxs), dw.to(w_out.dtype),
            None if bias is None else db.to(bias.dtype), None, None, None, None,
        )[:len(ctx.needs_input_grad)]


class _DenseLseCE(torch.autograd.Function):
    """Sum of per-token CE with the compute-dtype logits saved (the JAX
    ``_dense_lse_ce`` custom VJP): the backward recomputes no logits.
    ``grp`` as in ``_LseSavedCE``."""

    @staticmethod
    def forward(ctx, x, w_out, bias, ts_, cdt, z, grp=None):
        logits = _head_logits32(x, w_out.to(cdt), bias, cdt)
        lse = vocab_lse(logits, grp)
        label = vocab_label(logits, ts_, grp)
        total = (lse - label).sum()
        if z:
            total = total + z * lse.square().sum()
        ctx.save_for_backward(x, w_out, bias, ts_, logits.to(cdt), lse)
        ctx.cdt, ctx.z = cdt, z
        return total

    @staticmethod
    def backward(ctx, g):
        x, w_out, bias, ts_, logits_c, lse = ctx.saved_tensors
        cdt, z = ctx.cdt, ctx.z
        p = torch.exp(logits_c.float() - lse[:, None])
        if z:
            p = p * (1.0 + 2.0 * z * lse[:, None])
        dlogits = _subtract_onehot(p, ts_) * g
        dx = dlogits @ w_out.to(cdt).float().T
        dw = x.to(cdt).float().T @ dlogits
        db = None if bias is None else dlogits.sum(0).to(bias.dtype)
        return (dx.to(x.dtype), dw.to(w_out.dtype), db, None, None, None, None)[:len(ctx.needs_input_grad)]


_CE_CHUNK_BYTES = 512 * 1024 * 1024  # target fp32 logits per chunk


def _ce_chunks(s: int, vocab_size: int) -> int:
    """The JAX package's chunk count: chunk only when the (S, V) fp32
    logits pass 512 MB; then the smallest divisor of S at least the wanted
    count with chunks of >= 512 tokens, else the largest such divisor (with
    a warning when that leaves chunks above the target)."""
    logits_bytes = s * vocab_size * 4
    want = max(1, -(-logits_bytes // _CE_CHUNK_BYTES))
    if want == 1:
        return 1
    divisors = [c for c in range(2, s // 512 + 1) if s % c == 0]
    at_least = [c for c in divisors if c >= want]
    n_chunks = min(at_least) if at_least else (max(divisors) if divisors else 1)
    if n_chunks < want:
        warnings.warn(
            f"chunked CE head: batch*seq={s} has no divisor >= {want} with "
            f"chunk >= 512; using {n_chunks} chunks — logits memory "
            f"{logits_bytes / n_chunks / 2**20:.0f} MB/chunk exceeds the "
            "512 MB target. Prefer power-of-two batch*context products.",
            stacklevel=3,
        )
    return n_chunks


def _chunked_ce(
    hidden: torch.Tensor, w_out: torch.Tensor, bias: Optional[torch.Tensor],
    targets: torch.Tensor, cfg: ModelConfig, z: float = 0.0,
) -> torch.Tensor:
    """Mean cross-entropy over (B, T) targets through the configured head:
    ``ce_impl="chunked"`` (lse saved, logits recomputed per chunk), "dense"
    (compute-dtype logits saved) or "fused" (the fused CE kernels, no
    logits; ``ops/fused_ce.py``; on a data, fsdp or expert mesh each rank's
    rows). A biased head, or a mesh that shards the tensor, seq or pipe
    axis, asked for "fused" warns and takes the chunked head, as the JAX
    package does. On a tensor mesh ``w_out``/``bias`` are the rank's
    vocabulary columns and the head is vocabulary-parallel."""
    cdt = torch_dtype(cfg.compute_dtype)
    b, t, d = hidden.shape
    s = b * t
    mesh = current_mesh()
    if cfg.ce_impl == "fused":
        mesh_split = any(axis_size(mesh, ax) > 1 for ax in ("tensor", "seq", "pipe"))
        if bias is None and not mesh_split:
            losses = fused_cross_entropy(
                hidden.to(cdt).reshape(s, d).contiguous(), w_out.to(cdt), targets.reshape(s)
            )
            return losses.mean()
        why = ("the lm_head has a bias" if bias is not None
               else "the mesh shards tensor/seq/pipe axes the kernel can't express")
        warnings.warn(
            f"ce_impl='fused' degraded to chunked CE: {why}. "
            "Drop lm_head_bias / use a data+fsdp-only mesh to get the "
            "fused kernel.",
            stacklevel=3,
        )
    tp = tensor_group(mesh)
    if tp is not None:
        hidden = copy_to_group(hidden, tp)
        targets = targets - tp.index * w_out.shape[1]
    if cfg.ce_impl == "dense":
        return _DenseLseCE.apply(hidden.reshape(s, d), w_out, bias, targets.reshape(s), cdt, z, tp) / s
    n_chunks = _ce_chunks(s, cfg.vocab_size)
    xs = hidden.reshape(n_chunks, s // n_chunks, d)
    ts_ = targets.reshape(n_chunks, s // n_chunks)
    return _LseSavedCE.apply(xs, w_out, bias, ts_, cdt, z, tp) / s


def loss_fn(
    params: Params, tokens: torch.Tensor, targets: torch.Tensor, cfg: ModelConfig, *,
    include_aux: bool = True, blocks_baked: bool = False,
) -> torch.Tensor:
    """Mean next-token cross-entropy in fp32 through the configured CE head
    (``_chunked_ce``). z-loss (``cfg.z_loss_coef``) and, for a MoE model,
    ``cfg.router_aux_coef`` times the router's load-balance loss are part of
    the training objective only: ``include_aux=False`` (eval) reports pure
    cross-entropy.

    Under an active mesh (``parallel.sharding.activation_mesh``) tokens and
    targets are this rank's rows of the global batch (its data x fsdp
    block), every column, and the result is this rank's part of the global
    mean: summed over the ranks that split the tokens (data, fsdp, and seq
    when ``sequence_shards`` > 1) it is the mean. With ring or Ulysses
    attention over n seq ranks the rank keeps its n-th of the columns; with
    ring attention in the zigzag layout the columns are first permuted into
    the balanced chunk-pair layout (``parallel.zigzag``; mean CE is
    permutation invariant), or, when T is not divisible by 2n, kept
    contiguous with a warning, as the JAX package does. The tensor and
    expert ranks of a data group hold the same rows and compute the same
    loss; nothing divides by their count. On the pipelined path
    (``use_pipeline``; ``blocks_baked`` as in ``forward``) each pipe rank's
    head and loss run on its T / S columns of its pipeline rows, and the
    pipe ranks join the token axes; the aux loss is the pipeline's (summed
    over the stages, averaged over microbatches), counted once over them."""
    mesh = current_mesh()
    n_seq = sequence_shards(cfg, mesh)
    positions = None
    zigzag = False
    if n_seq > 1:
        t = tokens.shape[1]
        if t % n_seq:
            raise ValueError(f"seq_len={t} must divide by the seq axis ({n_seq})")
        perm = None
        if cfg.attention_impl == "ring" and cfg.ring_layout == "zigzag":
            if t % (2 * n_seq) == 0:
                perm = torch.from_numpy(zigzag_perm(t, n_seq)).to(tokens.device)
                zigzag = True
            else:
                warnings.warn(
                    f"ring_layout='zigzag' configured but seq_len={t} is not "
                    f"divisible by 2*seq_axis={2 * n_seq}; falling back to the "
                    "imbalanced contiguous ring layout (utilization ~(n+1)/2n).",
                    stacklevel=2,
                )
        tl = t // n_seq
        lo = coordinate(mesh)["seq"] * tl
        positions = (perm if perm is not None else torch.arange(t, device=tokens.device))[lo:lo + tl]
        tokens = tokens[:, positions]
        targets = targets[:, positions]
    n_pipe = 1
    if use_pipeline(cfg, mesh):
        n_pipe = axis_size(mesh, "pipe")
        rows = _pipeline_row_map(tokens.shape[0], cfg, mesh)
        if rows is not None:
            targets = _take_rows(targets, rows)
        targets = pipeline.rank_columns(targets, mesh)
    out = forward(params, tokens, cfg, positions=positions, zigzag=zigzag, return_pre_logits=True,
                  return_aux=bool(cfg.n_experts), blocks_baked=blocks_baked)
    w_out, bias = _lm_head_weights(params, cfg)
    loss = _chunked_ce(
        out[0], w_out, bias, targets.long(), cfg,
        z=cfg.z_loss_coef if include_aux else 0.0,
    )
    if cfg.n_experts and include_aux:
        loss = loss + cfg.router_aux_coef * out[2]
    if mesh is not None:
        loss = loss / (axis_size(mesh, "data") * axis_size(mesh, "fsdp") * n_seq * n_pipe)
    return loss
