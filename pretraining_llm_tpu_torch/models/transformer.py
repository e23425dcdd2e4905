"""Decoder-only transformer: init/forward over a dict of parameter tensors.

Counterpart of ``pretraining_llm_tpu/models/transformer.py`` for serving.
Parameters keep the JAX tree's names and layouts — block parameters are
stacked with a leading n_layers dim (``blocks.attn.wqkv`` is (L, d, 3, H,
Dh)) — so ``models.bridge`` maps one tree onto the other leaf for leaf.

``forward`` covers three cases:
  - no cache (T tokens of self-attention);
  - a dense cache at index 0: the admission prefill, which writes K/V
    into the cache and attends causally over the block's own q/k/v
    (``attention_impl="flash"`` goes to the flash kernel);
  - paged decode: each row writes its T query tokens' K/V into its pool
    pages at slots seq..seq+T-1, then attends over its pages —
    ``paged_attention_impl="kernel"`` through the paged kernel, "gather"
    through the plain gather path.

Matmuls run in ``compute_dtype`` and round their result to it, as the JAX
einsums with fp32 accumulation then ``astype(cdt)`` do; norms run in fp32;
the output head multiplies compute-dtype operands with fp32 accumulation
and returns fp32 logits. PyTorch runs eagerly, so the KV cache and the pools
are updated in place and returned.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple, Union

import torch

from pretraining_llm_tpu_torch.config import ModelConfig
from pretraining_llm_tpu_torch.models import layers
from pretraining_llm_tpu_torch.ops.attention import naive_attention
from pretraining_llm_tpu_torch.ops.cuda_paged import (
    paged_decode_attention,
    paged_decode_attention_reference,
)
from pretraining_llm_tpu_torch.ops.flash_attention import flash_attention
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
    q_lens: Optional[torch.Tensor] = None  # ragged multi-token calls: not ported


def check_ported(cfg: ModelConfig) -> None:
    """Refuse the options that change what the model computes but are not
    ported to PyTorch yet."""
    unported = []
    if cfg.n_experts:
        unported.append("n_experts (mixture of experts)")
    if cfg.attention_impl in ("ring", "ulysses"):
        unported.append(f"attention_impl={cfg.attention_impl!r}")
    if cfg.kv_cache_dtype != "compute":
        unported.append(f"kv_cache_dtype={cfg.kv_cache_dtype!r}")
    if cfg.doc_mask_token >= 0:
        unported.append("doc_mask_token (document masking)")
    if cfg.pipeline_stages > 1:
        unported.append("pipeline_stages > 1")
    if cfg.sequence_parallel:
        unported.append("sequence_parallel")
    if unported:
        raise NotImplementedError(
            "not ported to PyTorch yet: " + ", ".join(unported)
        )


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
    if cfg.activation == "swiglu":
        mlp: Params = {"w1": (d, 2, f), "w2": (f, d)}
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
    """GPT-2 style init: N(0, 0.02) everywhere, residual-output projections
    (wo, w2) scaled by 1/sqrt(2*n_layers), zeros for biases, ones for norm
    scales. Values are drawn on the generator's device (an int seeds a CPU
    generator, so one seed gives the same weights on every device) and
    moved to ``device``."""
    check_ported(cfg)
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


def make_kv_cache(
    cfg: ModelConfig, batch_size: int, max_length: int, dtype: Any = None, *,
    device: DeviceLike = None,
) -> KVCache:
    """Dense prefill cache {'k', 'v'}: (L, B, Tmax, kv_heads, Dh)."""
    if max_length > cfg.context_length:
        raise ValueError(
            f"kv cache max_length={max_length} exceeds context_length={cfg.context_length}"
        )
    dt = dtype or torch_dtype(cfg.compute_dtype)
    shape = (cfg.n_layers, batch_size, max_length, cfg.kv_heads, cfg.head_dim)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev)}


def make_paged_kv_pool(
    cfg: ModelConfig, n_blocks: int, block_size: int, dtype: Any = None, *,
    device: DeviceLike = None,
) -> KVCache:
    """Block pools for paged serving: {'layers': [{'k_pool', 'v_pool'}, ...]}
    with one (n_blocks, block_size, kv_heads, Dh) pool per layer, updated in
    place. Block 0 is reserved as the scratch target of idle rows and
    overshoot writes; allocators hand out ids from 1."""
    if n_blocks < 2:
        raise ValueError("need n_blocks >= 2 (block 0 is the idle scratch)")
    if block_size % 8:
        raise ValueError(f"block_size must be a multiple of 8, got {block_size}")
    check_ported(cfg)
    dt = dtype or torch_dtype(cfg.compute_dtype)
    dev = resolve_device(device)
    shape = (n_blocks, block_size, cfg.kv_heads, cfg.head_dim)
    return {
        "layers": [
            {"k_pool": torch.zeros(shape, dtype=dt, device=dev),
             "v_pool": torch.zeros(shape, dtype=dt, device=dev)}
            for _ in range(cfg.n_layers)
        ]
    }


def _is_pool_cache(kv_cache: Optional[KVCache]) -> bool:
    return kv_cache is not None and "layers" in kv_cache and "k_pool" in kv_cache["layers"][0]


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _mm(x: torch.Tensor, w: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    """x (..., K) @ w (K, ...) in compute dtype; w's trailing dims flatten."""
    k = w.shape[0]
    out = x.to(cdt) @ w.to(cdt).reshape(k, -1)
    return out.reshape(x.shape[:-1] + w.shape[1:])


def _positions_of_rows(seq_lens: torch.Tensor, t: int, limit: int) -> torch.Tensor:
    """(B, T) logical positions seq + i of each row's query tokens, clipped
    to the position tables (overshoot rows hold scratch garbage by
    contract; JAX gathers clamp out-of-range indices the same way)."""
    pos = seq_lens.long()[:, None] + torch.arange(t, device=seq_lens.device)[None, :]
    return pos.clamp(0, limit - 1)


def _attention_block(
    blk: Params, x: torch.Tensor, cfg: ModelConfig,
    rope: Optional[Tuple[torch.Tensor, torch.Tensor]], positions: torch.Tensor,
    kv: Optional[Params], paged: Optional[PagedInfo],
) -> torch.Tensor:
    """Pre-LN attention sub-block: x + attn(ln1(x)). ``kv`` (one layer's
    dense cache or pools) is written in place."""
    cdt = torch_dtype(cfg.compute_dtype)
    b, t, _ = x.shape
    h = layers.apply_norm(cfg.norm, blk["ln1"], x, cfg.norm_eps)
    attn = blk["attn"]
    if "wqkv" in attn:
        qkv = _mm(h, attn["wqkv"], cdt)  # (B, T, 3, H, Dh)
        if "bqkv" in attn:
            qkv = qkv + attn["bqkv"].to(cdt)
        q, k, v = qkv.unbind(2)
    else:
        q = _mm(h, attn["wq"], cdt)  # (B, T, H, Dh)
        kvp = _mm(h, attn["wkv"], cdt)  # (B, T, 2, G, Dh)
        if "bq" in attn:
            q = q + attn["bq"].to(cdt)
            kvp = kvp + attn["bkv"].to(cdt)
        k, v = kvp.unbind(2)

    if rope is not None:
        cos, sin = rope
        rope_pos = (
            _positions_of_rows(paged.seq_lens, t, cfg.context_length)
            if paged is not None else positions
        )
        q = layers.apply_rope(q, cos, sin, rope_pos)
        k = layers.apply_rope(k, cos, sin, rope_pos)

    window = cfg.sliding_window
    if kv is not None and "k_pool" in kv:
        out = _paged_attention(q, k, v, kv, paged, cfg, cdt)
    elif kv is not None:
        # Admission prefill at cache index 0: write the block's K/V, then
        # attend causally over this block's own q/k/v — exactly attention
        # over the written cache prefix [0, T).
        kv["k"][:, :t] = k
        kv["v"][:, :t] = v
        if t > 1 and cfg.attention_impl == "flash":
            out = flash_attention(q, k, v, window=window)
        else:
            tmax = kv["k"].shape[1]
            kv_pos = torch.arange(tmax, device=x.device)
            out = naive_attention(
                q, kv["k"].to(cdt), kv["v"].to(cdt), q_positions=positions,
                kv_positions=kv_pos, kv_mask=(kv_pos < t)[None, :].expand(b, tmax),
                window=window,
            )
    elif cfg.attention_impl == "flash":
        out = flash_attention(q, k, v, window=window)
    else:
        out = naive_attention(q, k, v, causal=True, window=window)

    if cfg.use_output_proj:
        out = _mm(out.reshape(b, t, -1), attn["wo"].reshape(-1, cfg.d_model), cdt)
        out = out + attn["bo"].to(cdt)
    else:
        out = out.reshape(b, t, cfg.n_heads * cfg.head_dim)
    return x + out.to(x.dtype)


def _paged_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv: Params,
    paged: Optional[PagedInfo], cfg: ModelConfig, cdt: torch.dtype,
) -> torch.Tensor:
    """Write token i of each row at its logical slot seq + i through the
    row's block table, then attend over the row's pages."""
    if paged is None:
        raise ValueError("a paged kv pool requires forward(..., paged=PagedInfo)")
    b, t = q.shape[:2]
    if paged.q_lens is not None and t > 1:
        raise NotImplementedError(
            "PagedInfo.q_lens (ragged multi-token paged attention: chunked "
            "prefill, prefix-cache suffixes) is not ported to PyTorch yet"
        )
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
    k_pool[blk_ids, slots] = k.to(k_pool.dtype)
    v_pool[blk_ids, slots] = v.to(v_pool.dtype)

    qin = q[:, 0] if t == 1 else q
    attend = (
        paged_decode_attention if cfg.paged_attention_impl == "kernel"
        else paged_decode_attention_reference
    )
    out = attend(
        qin.to(cdt).contiguous(), k_pool.to(cdt), v_pool.to(cdt), tables, seq,
        window=cfg.sliding_window,
    )
    return out[:, None] if t == 1 else out


def _mlp_block(blk: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Pre-LN MLP sub-block: x + mlp(ln2(x))."""
    cdt = torch_dtype(cfg.compute_dtype)
    h = layers.apply_norm(cfg.norm, blk["ln2"], x, cfg.norm_eps).to(cdt)
    mlp = blk["mlp"]
    if cfg.activation == "swiglu":
        gates = _mm(h, mlp["w1"], cdt)  # (B, T, 2, f)
        if "b1" in mlp:
            gates = gates + mlp["b1"].to(cdt)
        hidden = torch.nn.functional.silu(gates[..., 0, :]) * gates[..., 1, :]
    else:
        hidden = _mm(h, mlp["w1"], cdt)
        if "b1" in mlp:
            hidden = hidden + mlp["b1"].to(cdt)
        hidden = layers.activation_fn(cfg.activation, hidden)
    out = _mm(hidden, mlp["w2"], cdt)
    if "b2" in mlp:
        out = out + mlp["b2"].to(cdt)
    return x + out.to(x.dtype)


def _layer(tree: Params, i: int) -> Params:
    """Layer i's parameters: views into the stacked block tensors."""
    return {k: _layer(s, i) if isinstance(s, dict) else s[i] for k, s in tree.items()}


def forward(
    params: Params,
    tokens: torch.Tensor,
    cfg: ModelConfig,
    *,
    positions: Optional[torch.Tensor] = None,
    kv_cache: Optional[KVCache] = None,
    cache_index: Optional[int] = None,
    paged: Optional[PagedInfo] = None,
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """tokens (B, T) -> (logits (B, T, V) fp32, kv_cache).

    ``kv_cache`` from ``make_kv_cache`` with ``cache_index=0`` is the
    admission prefill; a pool from ``make_paged_kv_pool`` with ``paged``
    is paged decode (T uniform query tokens per row). Caches are updated
    in place and returned."""
    check_ported(cfg)
    cdt = torch_dtype(cfg.compute_dtype)
    b, t = tokens.shape
    device = tokens.device
    if paged is not None and not _is_pool_cache(kv_cache):
        raise ValueError("paged=PagedInfo requires a pool-layout kv_cache (make_paged_kv_pool)")
    if paged is None and _is_pool_cache(kv_cache):
        raise ValueError("a pool-layout kv_cache requires forward(..., paged=PagedInfo)")
    if kv_cache is not None and paged is None and int(cache_index or 0) != 0:
        raise NotImplementedError(
            "a cached forward at a nonzero cache_index (chunked prefill) is "
            "not ported to PyTorch yet"
        )
    if positions is None:
        positions = torch.arange(t, device=device)

    x = params["tok_embed"]["embedding"][tokens].to(cdt)
    rope = None
    if cfg.pos_embed == "learned":
        pos_table = params["pos_embed"]["embedding"]
        if paged is not None:
            ppos = _positions_of_rows(paged.seq_lens, t, cfg.context_length)
            x = x + pos_table[ppos].to(cdt)
        else:
            x = x + pos_table[positions].to(cdt)[None]
    else:
        rope = layers.rope_table(cfg.context_length, cfg.head_dim, cfg.rope_theta, device)

    for i in range(cfg.n_layers):
        blk = _layer(params["blocks"], i)
        layer_kv = None
        if paged is not None:
            layer_kv = kv_cache["layers"][i]
        elif kv_cache is not None:
            layer_kv = {"k": kv_cache["k"][i], "v": kv_cache["v"][i]}
        x = _attention_block(blk, x, cfg, rope, positions, layer_kv, paged)
        x = _mlp_block(blk, x, cfg)

    x = layers.apply_norm(cfg.norm, params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        w_out, bias = params["tok_embed"]["embedding"].T, None
    else:
        w_out, bias = params["lm_head"]["kernel"], params["lm_head"].get("bias")
    # Compute-dtype operands, fp32 accumulation and fp32 logits.
    logits = x.to(cdt).float() @ w_out.to(cdt).float()
    if bias is not None:
        logits = logits + bias.float()
    return logits, kv_cache
