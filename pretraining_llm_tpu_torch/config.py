"""Model configuration for the PyTorch port.

A copy of the JAX package's ``ModelConfig`` (same field names, defaults and
validation), so that one kwargs dict builds the config of either package,
plus the model presets the port serves. The port keeps its own copy rather
than importing the JAX package's module.

Several fields are tuning knobs of the XLA/TPU program (``flash_block_q``,
``flash_block_kv``, ``flash_heads_major``, ``remat``, ``scan_unroll``,
``decode_unroll_layers``, ``decode_cache_layout``, ``decode_loop_max_tokens``,
``ragged_kv_splits``, ``ragged_amla``, ``ce_impl``): they change no result,
and the port accepts and ignores them. Options that change what the model
computes but are not ported yet are refused where they would be used
(``models.transformer.check_ported``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

_ACTIVATIONS = ("relu", "gelu", "swiglu")
_NORMS = ("layernorm", "rmsnorm")
_POS_EMBEDS = ("learned", "rope")
_ATTN_IMPLS = ("naive", "flash", "ring", "ulysses")
_REMAT_POLICIES = ("none", "full", "dots_saveable", "save_attn",
                   "save_attn_res", "save_qkv_attn", "save_big")


@dataclass(frozen=True)
class ModelConfig:
    """Architecture of a decoder-only transformer (see the JAX package's
    ``config.ModelConfig`` for the meaning of every field)."""

    vocab_size: int = 50304
    context_length: int = 1024
    d_model: int = 768
    n_heads: int = 12
    n_layers: int = 12
    d_head: Optional[int] = None  # defaults to d_model // n_heads
    n_kv_heads: Optional[int] = None  # grouped-query attention; None = MHA
    mlp_ratio: float = 4.0
    activation: str = "gelu"  # relu | gelu | swiglu
    norm: str = "layernorm"  # layernorm | rmsnorm
    pos_embed: str = "learned"  # learned | rope
    rope_theta: float = 10000.0
    use_output_proj: bool = True
    tie_embeddings: bool = True
    lm_head_bias: bool = False
    qkv_bias: bool = False
    mlp_bias: bool = True
    norm_eps: float = 1e-5
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    attention_impl: str = "naive"  # naive | flash | ring | ulysses
    ring_layout: str = "zigzag"
    flash_block_q: int = 0
    flash_block_kv: int = 0
    flash_heads_major: bool = False
    remat: str = "none"
    ce_impl: str = "chunked"  # chunked | fused | dense
    z_loss_coef: float = 0.0
    scan_unroll: int = 1
    decode_unroll_layers: bool = False
    decode_cache_layout: str = "unstacked"
    decode_loop_max_tokens: int = 8
    sequence_parallel: bool = False
    sliding_window: int = 0
    doc_mask_token: int = -1
    n_experts: int = 0
    experts_per_token: int = 2
    expert_capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    moe_group_size: int = 2048
    pipeline_stages: int = 1
    pipeline_microbatches: int = 4
    pipeline_interleave: int = 1
    kv_cache_dtype: str = "compute"  # compute | int8
    # Paged decode attention: "gather" assembles each row's KV from the
    # pool before a masked softmax; "kernel" reads the pool pages straight
    # through the block table (ops/cuda_paged.py).
    paged_attention_impl: str = "gather"  # gather | kernel
    ragged_kv_splits: int = 1
    ragged_amla: bool = False

    def __post_init__(self) -> None:
        if self.kv_cache_dtype not in ("compute", "int8"):
            raise ValueError(
                f"kv_cache_dtype must be 'compute' or 'int8', got "
                f"{self.kv_cache_dtype!r}"
            )
        if self.paged_attention_impl not in ("gather", "kernel"):
            raise ValueError(
                f"paged_attention_impl must be 'gather' or 'kernel', got "
                f"{self.paged_attention_impl!r}"
            )
        if self.ragged_kv_splits < 0:
            raise ValueError(
                f"ragged_kv_splits must be >= 0 (0 = auto), got "
                f"{self.ragged_kv_splits}"
            )
        if self.activation not in _ACTIVATIONS:
            raise ValueError(f"activation must be one of {_ACTIVATIONS}, got {self.activation!r}")
        if self.norm not in _NORMS:
            raise ValueError(f"norm must be one of {_NORMS}, got {self.norm!r}")
        if self.pos_embed not in _POS_EMBEDS:
            raise ValueError(f"pos_embed must be one of {_POS_EMBEDS}, got {self.pos_embed!r}")
        if self.attention_impl not in _ATTN_IMPLS:
            raise ValueError(
                f"attention_impl must be one of {_ATTN_IMPLS}, got {self.attention_impl!r}"
            )
        if self.remat not in _REMAT_POLICIES:
            raise ValueError(f"remat must be one of {_REMAT_POLICIES}, got {self.remat!r}")
        if self.decode_cache_layout not in ("stacked", "unstacked"):
            raise ValueError(
                "decode_cache_layout must be 'stacked' or 'unstacked', got "
                f"{self.decode_cache_layout!r}"
            )
        if self.decode_loop_max_tokens < 1:
            raise ValueError(
                f"decode_loop_max_tokens must be >= 1, got "
                f"{self.decode_loop_max_tokens}"
            )
        if self.decode_unroll_layers and self.decode_cache_layout != "stacked":
            raise ValueError(
                "decode_unroll_layers requires decode_cache_layout="
                "'stacked' (the unstacked layout has no depth scan to "
                "unroll)"
            )
        if self.ce_impl not in ("chunked", "fused", "dense"):
            raise ValueError(
                f"ce_impl must be 'chunked', 'fused' or 'dense', got {self.ce_impl!r}"
            )
        if self.ring_layout not in ("contiguous", "zigzag"):
            raise ValueError(
                f"ring_layout must be 'contiguous' or 'zigzag', got {self.ring_layout!r}"
            )
        if self.d_model % self.n_heads != 0 and self.d_head is None:
            raise ValueError(
                f"d_model={self.d_model} not divisible by n_heads={self.n_heads}; set d_head"
            )
        if self.n_kv_heads is not None and (
            not 1 <= self.n_kv_heads <= self.n_heads
            or self.n_heads % self.n_kv_heads != 0
        ):
            raise ValueError(
                f"n_kv_heads={self.n_kv_heads} must divide n_heads={self.n_heads}"
            )
        if not self.use_output_proj and self.head_dim * self.n_heads != self.d_model:
            raise ValueError("use_output_proj=False requires n_heads*d_head == d_model")
        if self.tie_embeddings and self.lm_head_bias:
            raise ValueError("tie_embeddings is incompatible with lm_head_bias")
        if self.n_experts:
            if not 1 <= self.experts_per_token <= self.n_experts:
                raise ValueError(
                    f"experts_per_token={self.experts_per_token} must be in "
                    f"[1, n_experts={self.n_experts}]"
                )
            if self.expert_capacity_factor <= 0:
                raise ValueError("expert_capacity_factor must be positive")
            if self.moe_group_size < 0:
                raise ValueError("moe_group_size must be >= 0 (0 = one global group)")
        if self.pipeline_stages < 1 or self.n_layers % self.pipeline_stages != 0:
            raise ValueError(
                f"pipeline_stages={self.pipeline_stages} must divide "
                f"n_layers={self.n_layers}"
            )
        if self.pipeline_microbatches < 1:
            raise ValueError("pipeline_microbatches must be >= 1")
        if self.pipeline_interleave < 1 or (
            self.n_layers % (self.pipeline_stages * self.pipeline_interleave) != 0
        ):
            raise ValueError(
                f"pipeline_interleave={self.pipeline_interleave} x "
                f"pipeline_stages={self.pipeline_stages} must divide "
                f"n_layers={self.n_layers}"
            )
        if self.pipeline_interleave > 1:
            if self.pipeline_stages == 1:
                raise ValueError(
                    "pipeline_interleave > 1 does nothing without "
                    "pipeline_stages > 1"
                )
            if self.pipeline_microbatches < self.pipeline_stages:
                raise ValueError(
                    "pipeline_interleave > 1 requires pipeline_microbatches >= "
                    f"pipeline_stages ({self.pipeline_microbatches} < "
                    f"{self.pipeline_stages})"
                )
        if self.pipeline_stages > 1 and (
            self.attention_impl in ("ring", "ulysses") or self.sequence_parallel
        ):
            raise ValueError(
                "pipeline parallelism does not compose with sequence/context "
                "parallelism (ring/ulysses attention or sequence_parallel)"
            )
        if self.z_loss_coef < 0:
            raise ValueError("z_loss_coef must be >= 0")
        if self.z_loss_coef > 0 and self.ce_impl == "fused":
            raise ValueError(
                "z_loss_coef requires ce_impl='chunked' or 'dense' (the "
                "fused CE kernel does not implement the z term)"
            )
        if self.sliding_window < 0:
            raise ValueError("sliding_window must be >= 0 (0 = full causal)")
        if self.sliding_window > 0 and self.attention_impl in ("ring", "ulysses"):
            raise ValueError(
                "sliding_window is not supported by ring/ulysses attention "
                "(the rotating/all-to-all layouts assume full causal KV)"
            )
        if self.doc_mask_token >= 0:
            if self.attention_impl in ("ring", "ulysses"):
                raise ValueError(
                    "doc_mask_token (packed-document masking) is not "
                    "supported by ring/ulysses attention"
                )
            if self.pipeline_stages > 1:
                raise ValueError(
                    "doc_mask_token does not compose with pipeline parallelism"
                )
            if self.doc_mask_token >= self.vocab_size:
                raise ValueError(
                    f"doc_mask_token={self.doc_mask_token} is outside the "
                    f"vocabulary (vocab_size={self.vocab_size})"
                )

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head is not None else self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads if self.n_kv_heads is not None else self.n_heads

    @property
    def d_ff(self) -> int:
        return int(self.mlp_ratio * self.d_model)

    def num_params(self) -> int:
        """Analytic parameter count (matches ``init_params``; tested)."""
        d, h, dh, f, v, t = (
            self.d_model, self.n_heads, self.head_dim, self.d_ff,
            self.vocab_size, self.context_length,
        )
        g = self.kv_heads
        n = v * d
        if self.pos_embed == "learned":
            n += t * d
        norm = 2 * d if self.norm == "layernorm" else d
        per_block = 2 * norm + d * h * dh + 2 * d * g * dh
        if self.qkv_bias:
            per_block += h * dh + 2 * g * dh
        if self.use_output_proj:
            per_block += h * dh * d + d
        if self.activation == "swiglu":
            mlp = d * 2 * f + f * d + ((2 * f + d) if self.mlp_bias else 0)
        else:
            mlp = d * f + f * d + ((f + d) if self.mlp_bias else 0)
        if self.n_experts:
            per_block += d * self.n_experts + self.n_experts * mlp
        else:
            per_block += mlp
        n += self.n_layers * per_block + norm
        if not self.tie_embeddings:
            n += d * v + (v if self.lm_head_bias else 0)
        return n


@dataclass(frozen=True)
class Config:
    """A named model configuration. The JAX package's ``Config`` also
    carries mesh, data and training settings; the port's serving slice
    needs only the model."""

    model: ModelConfig
    name: str = "custom"


def _gpt2_model(**kw: Any) -> ModelConfig:
    base = dict(
        vocab_size=50304,
        activation="gelu",
        norm="layernorm",
        pos_embed="learned",
        use_output_proj=True,
        tie_embeddings=True,
        qkv_bias=True,
        mlp_bias=True,
    )
    base.update(kw)
    return ModelConfig(**base)


def _llama_model(**kw: Any) -> ModelConfig:
    base = dict(
        activation="swiglu",
        norm="rmsnorm",
        pos_embed="rope",
        use_output_proj=True,
        tie_embeddings=False,
        lm_head_bias=False,
        qkv_bias=False,
        mlp_bias=False,
    )
    base.update(kw)
    return ModelConfig(**base)


_PRESETS: Dict[str, Config] = {}


def _register(name: str, model: ModelConfig) -> None:
    _PRESETS[name] = Config(model=model, name=name)


# GPT-2 124M: the model the serving slice runs at full width.
_register(
    "gpt2-124m",
    _gpt2_model(
        context_length=1024, d_model=768, n_heads=12, n_layers=12,
        attention_impl="flash",
    ),
)

# Llama-3-style 1B with grouped-query attention (4 KV heads for 16 query
# heads).
_register(
    "llama3-1b-gqa",
    _llama_model(
        vocab_size=32000,
        context_length=2048,
        d_model=2048,
        n_heads=16,
        n_kv_heads=4,
        n_layers=22,
        mlp_ratio=2.6875,
        attention_impl="flash",
        remat="dots_saveable",
    ),
)

# Tiny config for tests and smoke runs.
_register(
    "tiny",
    _gpt2_model(vocab_size=256, context_length=64, d_model=32, n_heads=4, n_layers=2),
)


def get_preset(name: str) -> Config:
    if name not in _PRESETS:
        raise KeyError(f"unknown preset {name!r}; available: {sorted(_PRESETS)}")
    return _PRESETS[name]


def list_presets() -> Tuple[str, ...]:
    return tuple(sorted(_PRESETS))
