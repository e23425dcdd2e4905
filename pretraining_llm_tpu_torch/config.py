"""Configuration for the PyTorch port.

Copies of the JAX package's ``ModelConfig``, ``DataConfig``,
``TrainConfig``, ``ResilienceConfig``, ``ObservabilityConfig``,
``ServingConfig``, ``FrontendConfig`` and ``MeshConfig`` (same field names, defaults and validation), so that one
kwargs dict builds the config of either package, and ``Config`` with those
sections, ``replace``, ``with_overrides`` and the JSON form
(``to_json``/``from_json``, the JAX package's text byte for byte), plus every preset of the JAX package with
its model, mesh and train sections field for field. A preset's
``batch_size`` is its global batch: its rows go over the mesh's data and
fsdp ranks (``parallel/``), and one rank runs it whole, in
``train.microbatches`` where one pass does not fit (the mean of the
microbatches' gradients is the batch's). A preset whose mesh fixes an axis
above 1 (``fsdp=4``) needs that many ranks, as the JAX package needs that
many devices: a single-device run of it states a one-device mesh
(``--override mesh.fsdp=1``). The port keeps its own copy rather than
importing the JAX package's module.

Several model fields are tuning knobs of the XLA/TPU program
(``flash_heads_major``, ``scan_unroll``, ``decode_unroll_layers``,
``decode_cache_layout``, ``decode_loop_max_tokens``): they change no result,
and the port accepts and ignores them. ``remat`` picks the per-layer
activation checkpointing policy, as in JAX (``ops/remat.py``): it changes
memory and recompute, not the result. ``flash_block_q``/``flash_block_kv``
choose the flash backward's algorithm as they do in JAX (one block each:
the one-pass kernel; otherwise the dQ and dK/dV kernels); the CUDA kernels
tile T themselves. ``ragged_kv_splits``, ``ragged_amla`` and ``ce_impl``
("chunked", "dense" or "fused") choose between forms that compute the same
result.
``data.prefetch`` > 0 runs the sampler and the host-to-device copy that
many batches ahead on a thread (``data.loader.DevicePrefetcher``).
``data.use_native_batcher`` samples a single token file through the port's
copy of the C++ counter-based gatherer (``data/native_batcher.py``), as the
JAX trainer does, so both packages draw the same batches from one seed; a
mixture spec, or a host without a C++ compiler, takes the numpy sampler.
``ResilienceConfig`` (anomaly detection and rollback, the step watchdog,
fault drills) and ``ObservabilityConfig`` (the run-event, span and
Prometheus sinks) are the JAX package's, field for field, and so is
``FrontendConfig`` (the online gateway's knobs; its fleet fields are
refused by ``serve --http`` until the fleet is ported). Every model, mesh
and train option computes in the port (``pipeline_stages`` over the
mesh's pipe axis in ``parallel/pipeline.py``).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
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
                    "doc_mask_token does not compose with pipeline "
                    "parallelism (segments are not threaded through the "
                    "pipelined block path)"
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
        d, h, dh, v, t = self.d_model, self.n_heads, self.head_dim, self.vocab_size, self.context_length
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
        mlp = self._mlp_params()
        if self.n_experts:
            per_block += d * self.n_experts + self.n_experts * mlp
        else:
            per_block += mlp
        n += self.n_layers * per_block + norm
        if not self.tie_embeddings:
            n += d * v + (v if self.lm_head_bias else 0)
        return n

    def num_active_params(self) -> int:
        """Params one token's forward touches: ``num_params`` less, for a
        MoE model, the (n_experts - experts_per_token) expert FFNs a token
        does not run in each layer."""
        n = self.num_params()
        if self.n_experts:
            n -= self.n_layers * (self.n_experts - self.experts_per_token) * self._mlp_params()
        return n

    def _mlp_params(self) -> int:
        """One FFN's parameter count: the dense MLP, or one MoE expert."""
        d, f = self.d_model, self.d_ff
        if self.activation == "swiglu":
            return d * 2 * f + f * d + ((2 * f + d) if self.mlp_bias else 0)
        return d * f + f * d + ((f + d) if self.mlp_bias else 0)

    def flops_per_token(self) -> int:
        """Forward+backward training FLOPs per token, the JAX package's MFU
        count: 6 x active params (``num_active_params``) plus the causal
        attention term 12 * L * (n_heads * d_head) * T / 2."""
        d_attn = self.n_heads * self.head_dim
        return 6 * self.num_active_params() + 12 * self.n_layers * d_attn * self.context_length // 2


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# Mesh
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MeshConfig:
    """Logical mesh of ranks: (data, fsdp, tensor, seq, expert, pipe) axes,
    the JAX package's ``MeshConfig`` field for field (``parallel/mesh.py``
    builds it over ``torch.distributed`` ranks where JAX builds it over
    devices). Axes of size 1 cost nothing; ``data=-1`` absorbs all remaining
    ranks."""

    data: int = -1
    fsdp: int = 1
    tensor: int = 1
    seq: int = 1
    expert: int = 1
    pipe: int = 1

    axis_names: Tuple[str, ...] = ("data", "fsdp", "tensor", "seq", "expert", "pipe")

    def sizes(self, n_devices: int) -> Tuple[int, ...]:
        fixed = self.fsdp * self.tensor * self.seq * self.expert * self.pipe
        data = self.data
        if data == -1:
            if n_devices % fixed != 0:
                raise ValueError(
                    f"{n_devices} devices not divisible by fsdp*tensor*seq*expert*pipe={fixed}"
                )
            data = n_devices // fixed
        if data * fixed != n_devices:
            raise ValueError(
                f"mesh {data}x{self.fsdp}x{self.tensor}x{self.seq}"
                f"x{self.expert}x{self.pipe} != {n_devices} devices"
            )
        return (data, self.fsdp, self.tensor, self.seq, self.expert, self.pipe)


@dataclass(frozen=True)
class DataConfig:
    """Data pipeline config: flat uint16 token memmaps (the JAX package's
    ``DataConfig``)."""

    train_path: str = "data/train.bin"
    val_path: str = "data/val.bin"
    dataset_name: str = "openwebtext"
    tokenizer_name: str = "gpt2"
    val_fraction: float = 0.0005
    split_seed: int = 42
    sample_seed: int = 1337
    prefetch: int = 2  # batches sampled and copied ahead on a thread (0: synchronous)
    use_native_batcher: bool = True  # single files through the C++ gatherer (data/native_batcher.py)


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

_LR_SCHEDULES = ("warmup_constant", "warmup_cosine", "warmup_stable_decay")


@dataclass(frozen=True)
class TrainConfig:
    """Training config (the JAX package's ``TrainConfig``; see it for the
    meaning of every field)."""

    batch_size: int = 32
    microbatches: int = 1
    train_steps: int = 200_000
    eval_interval: int = 1000
    eval_iters: int = 250
    lr: float = 3e-4
    lr_schedule: str = "warmup_cosine"
    optimizer: str = "adamw"
    muon_momentum: float = 0.95
    warmup_frac: float = 0.1
    min_lr_frac: float = 0.1
    decay_frac: float = 0.1
    weight_decay: float = 0.1
    adam_b1: float = 0.9
    adam_b2: float = 0.95
    adam_eps: float = 1e-8
    grad_clip: float = 1.0  # 0 disables
    grad_dtype: str = "float32"  # float32 | bfloat16
    ema_decay: float = 0.0
    seed: int = 0
    checkpoint_dir: str = "checkpoints"
    checkpoint_interval: int = 1000
    keep_checkpoints: int = 3
    checkpoint_async: bool = False
    save_final: bool = True
    log_interval: int = 10
    metrics_path: str = ""
    debug_nans: bool = False
    profile_dir: str = ""
    profile_start: int = 10
    profile_steps: int = 5

    def __post_init__(self) -> None:
        if self.lr_schedule not in _LR_SCHEDULES:
            raise ValueError(f"lr_schedule must be one of {_LR_SCHEDULES}")
        if self.optimizer not in ("adamw", "adafactor", "muon"):
            raise ValueError(
                "optimizer must be 'adamw', 'adafactor', or 'muon', "
                f"got {self.optimizer!r}"
            )
        if not 0.0 < self.decay_frac <= 1.0:
            raise ValueError(
                f"decay_frac must be in (0, 1], got {self.decay_frac}"
            )
        if not 0.0 <= self.ema_decay < 1.0:
            raise ValueError(
                f"ema_decay must be in [0, 1), got {self.ema_decay}"
            )
        if self.batch_size % self.microbatches != 0:
            raise ValueError(
                f"batch_size={self.batch_size} not divisible by microbatches={self.microbatches}"
            )
        if self.grad_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"grad_dtype must be 'float32' or 'bfloat16', got "
                f"{self.grad_dtype!r}"
            )


# ---------------------------------------------------------------------------
# Resilience
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ResilienceConfig:
    """Fault-tolerance knobs: anomaly detection, rollback, watchdog, faults
    (the JAX package's ``ResilienceConfig``). All host-side: the detector
    reads the metrics the trainer already fetched at log boundaries, the
    watchdog is one idle thread, and fault injection does nothing unless
    ``faults`` is set (``resilience/``)."""

    # Anomaly detection over the log-boundary metrics. NaN/Inf needs no
    # history and is always armed; the spike rules compare against a rolling
    # median of ``anomaly_window`` samples once ``anomaly_min_history``
    # clean samples exist.
    anomaly_detection: bool = False
    anomaly_window: int = 32
    anomaly_min_history: int = 5
    loss_spike_factor: float = 3.0
    grad_spike_factor: float = 10.0
    # Rollbacks per train() call; the next anomaly past the budget ends the
    # run with exit_reason "anomaly_budget" (EXIT_ANOMALY).
    rollback_budget: int = 3
    # Steps after a rollback in which anomalies are logged, not acted on.
    cooldown_steps: int = 0
    # Batches skipped past the poison window on a rollback (the window
    # itself, anomaly step - restored step, is always skipped).
    skip_batches: int = 0
    # Host seconds without a completed step before the watchdog dumps every
    # thread's stack, attempts an emergency checkpoint and exits EXIT_WEDGED
    # (0 = off). It arms at the first completed step.
    watchdog_timeout_s: float = 0.0
    # Fault plan for drills, e.g. "nan@20,sigterm@50,hang@30,ckpt_truncate@40":
    # each entry fires once, right before the named step; a resumed run does
    # not re-fire entries at or below its start step. "" = off.
    faults: str = ""

    def __post_init__(self) -> None:
        if self.anomaly_window < 2:
            raise ValueError(
                f"anomaly_window must be >= 2, got {self.anomaly_window}"
            )
        if self.anomaly_min_history < 1:
            raise ValueError(
                f"anomaly_min_history must be >= 1, got {self.anomaly_min_history}"
            )
        if self.loss_spike_factor <= 1.0 or self.grad_spike_factor <= 1.0:
            raise ValueError(
                "spike factors must be > 1 (a factor <= 1 flags every step): "
                f"loss={self.loss_spike_factor}, grad={self.grad_spike_factor}"
            )
        if self.rollback_budget < 0:
            raise ValueError(
                f"rollback_budget must be >= 0, got {self.rollback_budget}"
            )
        if self.cooldown_steps < 0 or self.skip_batches < 0:
            raise ValueError("cooldown_steps and skip_batches must be >= 0")
        if self.watchdog_timeout_s < 0:
            raise ValueError(
                f"watchdog_timeout_s must be >= 0, got {self.watchdog_timeout_s}"
            )
        if self.faults:
            from pretraining_llm_tpu_torch.resilience.faults import parse_faults

            parse_faults(self.faults)  # a malformed plan fails here, naming its entry


# ---------------------------------------------------------------------------
# Observability
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ObservabilityConfig:
    """Run-wide telemetry sinks (the JAX package's ``ObservabilityConfig``).
    The in-memory pieces (event bus, goodput, build counting) always run, a
    few dict updates per log boundary; these fields gate the files and the
    memory sampler (``observability/``)."""

    # Run-event JSONL ("" = in memory only); obs_report reads it.
    events_path: str = ""
    # Chrome trace-event JSON of the host spans, written when train() ends.
    spans_path: str = ""
    # Prometheus textfile, rewritten atomically at every log boundary.
    prometheus_path: str = ""
    # Sample device memory every N log boundaries (0 = off): an allocator
    # query on the host, no device sync.
    device_memory_interval: int = 0
    # Count the port's kernel and library builds; a build after the first
    # completed step becomes a ``recompile`` event.
    compile_telemetry: bool = True

    def __post_init__(self) -> None:
        if self.device_memory_interval < 0:
            raise ValueError(
                f"device_memory_interval must be >= 0, got "
                f"{self.device_memory_interval}"
            )


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ServingConfig:
    """Decode-serving scheduler knobs (``generation/serving.py``), field for
    field the JAX package's. They gate host-side scheduling only: greedy
    tokens are the same at every setting."""

    # In-flight decode-window queue depth of the pipelined scheduler: how
    # many dispatched-but-unreaped windows the engine keeps before it
    # blocks on the oldest (1 = double buffering).
    pipeline_depth: int = 2
    # Defer waiting prefills until this many can be admitted in one batched
    # prefill (0 or 1 = admit eagerly); an idle engine always admits.
    admit_batch: int = 0
    # Cross-request prefix cache (``generation/prefix_cache.py``).
    prefix_cache: bool = False
    # Shortest cached prefix, in blocks, worth mapping.
    prefix_cache_min_blocks: int = 1
    # Chunked prefill: prompts stream in chunks of at most this many tokens
    # between decode windows (0 = monolithic prefill at admission).
    prefill_chunk_tokens: int = 0
    # Digest every published prefix-cache page and verify it when a later
    # admission acquires it (``resilience/integrity.py``).
    kv_checksum: bool = False
    # "none", "int8" (int8 block projections) or "int8-kv" (also int8 KV
    # pools with bf16 scale pages).
    quantize: str = "none"

    def __post_init__(self) -> None:
        if self.quantize not in ("none", "int8", "int8-kv"):
            raise ValueError(
                "serving.quantize must be 'none', 'int8' or 'int8-kv', "
                f"got {self.quantize!r}"
            )
        if self.pipeline_depth < 1:
            raise ValueError(
                f"pipeline_depth must be >= 1, got {self.pipeline_depth}"
            )
        if self.admit_batch < 0:
            raise ValueError(f"admit_batch must be >= 0, got {self.admit_batch}")
        if self.prefix_cache_min_blocks < 1:
            raise ValueError(
                "prefix_cache_min_blocks must be >= 1, got "
                f"{self.prefix_cache_min_blocks}"
            )
        if self.prefill_chunk_tokens < 0:
            raise ValueError(
                "prefill_chunk_tokens must be >= 0, got "
                f"{self.prefill_chunk_tokens}"
            )


@dataclass(frozen=True)
class FrontendConfig:
    """Online serving gateway knobs (frontend/).

    All host-side: none of these change emitted tokens. They bound what the
    HTTP frontend ADMITS, not how the engine schedules what was admitted.
    """

    # Gateway bind address. Port 0 binds an ephemeral port (tests read it
    # back from ServingGateway.port).
    host: str = "127.0.0.1"
    port: int = 8000
    # Backpressure: max requests admitted and not yet terminal; excess gets
    # HTTP 429 + Retry-After instead of an unbounded queue wait.
    max_queue_depth: int = 64
    # Outstanding-token budget (sum of prompt + max_new over live
    # requests); 0 = unlimited. A depth bound alone cannot tell ten tiny
    # requests from one huge one.
    max_outstanding_tokens: int = 0
    # Retry-After hint (seconds) attached to 429 responses.
    retry_after_s: float = 1.0
    # Reject requests whose optimistic service estimate (decode-only TPOT
    # EWMA) already exceeds their deadline, instead of admitting them to
    # miss it (HTTP 504 at submit time).
    shed_infeasible: bool = True
    # Default per-request deadline applied when the client sends none;
    # 0 = no default deadline.
    default_deadline_s: float = 0.0
    # How long the idle engine-loop thread sleeps between inbox polls.
    idle_wait_s: float = 0.005
    # Per-request tracing: head-sampling fraction for requests without an
    # inbound ``traceparent`` (whose own sampled flag is honored). 0 =
    # tracing off — the default, and the zero-cost path.
    trace_sample: float = 0.0
    # Chrome-trace JSON export path, written at gateway shutdown when
    # tracing is on ("" = no export).
    trace_path: str = ""
    # /healthz returns 503 once the engine loop has gone this many
    # seconds without completing a scheduler turn. 0 disables — the
    # default, because a cold-start jit compile legitimately holds the
    # loop thread for minutes on slow hosts.
    healthz_stale_after_s: float = 0.0
    # Capacity observability ring size: per-window occupancy samples and
    # scheduler decision records kept live for /debug/* (the event-bus
    # JSONL keeps everything regardless). 0 disables the layer.
    capacity_ring: int = 512
    # ---- fleet (frontend/router.py); replicas=1 keeps the single
    # EngineLoop path with zero router overhead. -----------------------
    # Number of engine replicas behind the router tier.
    replicas: int = 1
    # Where each replica's engine lives: "inproc" (an EngineLoop thread
    # in the gateway process) or "process" (one worker subprocess per
    # replica — frontend/worker.py — behind a socket, so a kill -9 or a
    # dropped connection is a REAL fault domain, not a simulated one).
    # The router/sentinel/gateway contract is identical in both modes.
    replica_mode: str = "inproc"
    # Prefix-affinity routing: prompt tokens hashed for placement. 0
    # disables affinity (pure least-loaded).
    affinity_tokens: int = 32
    # Spill off the affinity choice when it carries this many more
    # in-system requests than the least-loaded replica.
    spill_margin: int = 4
    # Watchdog: eject a replica whose loop has active requests but has
    # not completed a scheduler turn for this long. 0 disables (same
    # cold-jit rationale as healthz_stale_after_s).
    wedged_after_s: float = 0.0
    # Relaunch backoff for ejected replicas: initial and cap (doubles).
    eject_backoff_s: float = 0.5
    eject_backoff_max_s: float = 8.0
    # Max failovers per request before it errors out (renamed from
    # ``redrive_max`` — see MIGRATION.md): a request that kills every
    # replica it lands on gets a clean terminal error after this many
    # attempts instead of fueling a redrive storm.
    redrive_max_attempts: int = 3
    # Brownout: when the healthy fraction of the fleet drops below this,
    # shed low-priority / long-deadline work with 429. 0 disables.
    brownout_min_healthy_frac: float = 0.0
    # Under brownout: shed requests with priority below this ...
    brownout_min_priority: int = 1
    # ... or deadline longer than this (0 = don't shed on deadline).
    brownout_max_deadline_s: float = 0.0
    # ---- multi-host fleet (replica_mode="process" only). -------------
    # Attach to pre-spawned workers (``worker.py --listen host:port``)
    # instead of spawning subprocesses: comma-separated "host:port" list,
    # one address per replica ("" = spawn locally). Attached workers are
    # detached (never killed) at teardown, and the stdin-orphan watch is
    # replaced by heartbeat leases.
    worker_attach: str = ""
    # Shared secret for the attach handshake: the first frame on a new
    # connection must be a hello carrying this token or the worker drops
    # the connection ("" = no auth; spawn mode ignores it).
    attach_token: str = ""
    # Heartbeat lease: a worker that hears nothing from its router for
    # this long stops admitting, drains, and parks; the router, hearing
    # nothing back, redrives the worker's in-flight work. 0 disables
    # (spawn mode's stdin-orphan + conn-EOF detection still applies).
    lease_s: float = 0.0
    # Write-ahead fleet journal (append-only JSONL): membership, fence
    # generations, and per-request committed frontiers, enough for a
    # restarted router to re-attach survivors, fence the old generation,
    # and redrive in-flight requests bit-identically ("" = no journal).
    journal_path: str = ""
    # Journal compaction threshold in MB: once the JSONL grows past this,
    # the journal rewrites itself down to its recovery_plan fold (fences,
    # live request frontiers, next_frid) via an atomic tmp+rename. 0
    # disables rotation (the journal grows without bound).
    journal_rotate_mb: float = 64.0
    # Serving-path fault plan, e.g. "replica_crash@req3:r0,slow_window@req5"
    # ("" = none). See resilience.faults.parse_serving_faults.
    serving_faults: str = ""
    # Retry-After jitter: 429/503 headers carry base * U[1, 1+frac],
    # drawn from a PRNG seeded with retry_jitter_seed (deterministic for
    # tests; decorrelates client retry herds in prod).
    retry_jitter_frac: float = 0.25
    retry_jitter_seed: int = 0
    # ---- output-integrity sentinel (resilience/integrity.py). All off
    # by default: probes, fingerprints, and checksums add zero device
    # work until a knob turns them on. ---------------------------------
    # Golden-probe period: every interval the router injects a pinned
    # greedy probe into each active replica at strict-lowest priority and
    # quarantines any replica whose output diverges from the reference
    # pinned at startup. 0 disables the sentinel entirely.
    probe_interval_s: float = 0.0
    # How many distinct probes to pin (round-robined across intervals).
    probe_count: int = 2
    # Tokens each probe decodes; longer probes catch subtler divergence
    # at proportionally higher (lowest-priority) cost.
    probe_max_new: int = 4
    # Per-replica weight fingerprint recompute period (computed on each
    # loop thread between scheduler turns; compared by the sentinel
    # against the value pinned at launch). 0 disables.
    weight_fingerprint_interval_s: float = 0.0

    def __post_init__(self) -> None:
        if not 0 <= self.port <= 65535:
            raise ValueError(f"port must be in [0, 65535], got {self.port}")
        if not 0.0 <= self.trace_sample <= 1.0:
            raise ValueError(
                f"trace_sample must be in [0, 1], got {self.trace_sample}"
            )
        if self.healthz_stale_after_s < 0:
            raise ValueError(
                f"healthz_stale_after_s must be >= 0, got "
                f"{self.healthz_stale_after_s}"
            )
        if self.max_queue_depth < 1:
            raise ValueError(
                f"max_queue_depth must be >= 1, got {self.max_queue_depth}"
            )
        if self.max_outstanding_tokens < 0:
            raise ValueError(
                f"max_outstanding_tokens must be >= 0, got "
                f"{self.max_outstanding_tokens}"
            )
        if self.retry_after_s <= 0:
            raise ValueError(
                f"retry_after_s must be > 0, got {self.retry_after_s}"
            )
        if self.default_deadline_s < 0:
            raise ValueError(
                f"default_deadline_s must be >= 0, got {self.default_deadline_s}"
            )
        if self.idle_wait_s <= 0:
            raise ValueError(f"idle_wait_s must be > 0, got {self.idle_wait_s}")
        if self.capacity_ring < 0:
            raise ValueError(
                f"capacity_ring must be >= 0 (0 disables), got "
                f"{self.capacity_ring}"
            )
        if self.replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {self.replicas}")
        if self.affinity_tokens < 0:
            raise ValueError(
                f"affinity_tokens must be >= 0, got {self.affinity_tokens}"
            )
        if self.spill_margin < 1:
            raise ValueError(
                f"spill_margin must be >= 1, got {self.spill_margin}"
            )
        if self.wedged_after_s < 0:
            raise ValueError(
                f"wedged_after_s must be >= 0, got {self.wedged_after_s}"
            )
        if self.eject_backoff_s <= 0:
            raise ValueError(
                f"eject_backoff_s must be > 0, got {self.eject_backoff_s}"
            )
        if self.eject_backoff_max_s < self.eject_backoff_s:
            raise ValueError(
                "eject_backoff_max_s must be >= eject_backoff_s, got "
                f"{self.eject_backoff_max_s} < {self.eject_backoff_s}"
            )
        if self.replica_mode not in ("inproc", "process"):
            raise ValueError(
                f"replica_mode must be 'inproc' or 'process', got "
                f"{self.replica_mode!r}"
            )
        if self.redrive_max_attempts < 0:
            raise ValueError(
                f"redrive_max_attempts must be >= 0, got "
                f"{self.redrive_max_attempts}"
            )
        if self.lease_s < 0:
            raise ValueError(f"lease_s must be >= 0, got {self.lease_s}")
        if self.journal_rotate_mb < 0:
            raise ValueError(
                f"journal_rotate_mb must be >= 0 (0 disables rotation), "
                f"got {self.journal_rotate_mb}"
            )
        if self.worker_attach:
            if self.replica_mode != "process":
                raise ValueError(
                    "worker_attach needs replica_mode='process', got "
                    f"{self.replica_mode!r}"
                )
            addrs = [a.strip() for a in self.worker_attach.split(",")]
            if len(addrs) != self.replicas:
                raise ValueError(
                    f"worker_attach lists {len(addrs)} addresses for "
                    f"{self.replicas} replicas"
                )
            for a in addrs:
                host, _, port_s = a.rpartition(":")
                if not host or not port_s.isdigit():
                    raise ValueError(
                        f"worker_attach address {a!r} is not host:port"
                    )
        if self.attach_token and not self.worker_attach:
            raise ValueError("attach_token needs worker_attach addresses")
        if not 0.0 <= self.brownout_min_healthy_frac <= 1.0:
            raise ValueError(
                "brownout_min_healthy_frac must be in [0, 1], got "
                f"{self.brownout_min_healthy_frac}"
            )
        if self.brownout_max_deadline_s < 0:
            raise ValueError(
                "brownout_max_deadline_s must be >= 0, got "
                f"{self.brownout_max_deadline_s}"
            )
        if not 0.0 <= self.retry_jitter_frac <= 1.0:
            raise ValueError(
                "retry_jitter_frac must be in [0, 1], got "
                f"{self.retry_jitter_frac}"
            )
        if self.probe_interval_s < 0:
            raise ValueError(
                f"probe_interval_s must be >= 0, got {self.probe_interval_s}"
            )
        if self.probe_count < 1:
            raise ValueError(
                f"probe_count must be >= 1, got {self.probe_count}"
            )
        if self.probe_max_new < 1:
            raise ValueError(
                f"probe_max_new must be >= 1, got {self.probe_max_new}"
            )
        if self.weight_fingerprint_interval_s < 0:
            raise ValueError(
                "weight_fingerprint_interval_s must be >= 0, got "
                f"{self.weight_fingerprint_interval_s}"
            )


# ---------------------------------------------------------------------------
# Top-level
# ---------------------------------------------------------------------------

_SECTIONS = ("model", "mesh", "data", "train", "resilience", "obs", "serving", "frontend")


@dataclass(frozen=True)
class Config:
    """A named configuration: model, mesh, data, train, resilience, obs,
    serving and frontend sections, the JAX package's ``Config``."""

    model: ModelConfig = field(default_factory=ModelConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    resilience: ResilienceConfig = field(default_factory=ResilienceConfig)
    obs: ObservabilityConfig = field(default_factory=ObservabilityConfig)
    serving: ServingConfig = field(default_factory=ServingConfig)
    frontend: FrontendConfig = field(default_factory=FrontendConfig)
    name: str = "custom"

    def replace(self, **sections: Any) -> "Config":
        return dataclasses.replace(self, **sections)

    def with_overrides(self, overrides: Dict[str, Any]) -> "Config":
        """Apply dotted-path overrides, e.g. {"model.n_layers": 4}. Unknown
        keys raise ``KeyError``."""
        sections: Dict[str, Dict[str, Any]] = {}
        top: Dict[str, Any] = {}
        for key, value in overrides.items():
            if "." in key:
                section, fname = key.split(".", 1)
                if section not in _SECTIONS:
                    raise KeyError(f"unknown config section {section!r} in override {key!r}")
                sections.setdefault(section, {})[fname] = value
            else:
                if key != "name":
                    raise KeyError(f"unknown top-level config key {key!r}")
                top[key] = value
        new = self
        for section, kw in sections.items():
            old = getattr(new, section)
            valid = {f.name for f in dataclasses.fields(old)}
            for k in kw:
                if k not in valid:
                    raise KeyError(f"unknown config key {section}.{k}")
            new = dataclasses.replace(new, **{section: dataclasses.replace(old, **kw)})
        if top:
            new = dataclasses.replace(new, **top)
        return new

    @staticmethod
    def from_dict(raw: Dict[str, Any]) -> "Config":
        """The config a checkpoint's metadata stores (``extra["config"]``,
        written by either package's trainer). A checkpoint written before a
        section existed gets its defaults."""
        return Config(
            model=ModelConfig(**raw["model"]),
            mesh=MeshConfig(**{k: tuple(v) if k == "axis_names" else v
                               for k, v in raw.get("mesh", {}).items()}),
            data=DataConfig(**raw.get("data", {})),
            train=TrainConfig(**raw.get("train", {})),
            resilience=ResilienceConfig(**raw.get("resilience", {})),
            obs=ObservabilityConfig(**raw.get("obs", {})),
            serving=ServingConfig(**raw.get("serving", {})),
            frontend=FrontendConfig(**raw.get("frontend", {})),
            name=raw.get("name", "custom"),
        )

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @staticmethod
    def from_json(text: str) -> "Config":
        """The inverse of ``to_json``, of either package's text."""
        return Config.from_dict(json.loads(text))


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


def _register(name: str, model: ModelConfig, **sections: Any) -> None:
    _PRESETS[name] = Config(model=model, name=name, **sections)


# GPT-2 124M: the model the serving and training slices run at full width.
_register(
    "gpt2-124m",
    _gpt2_model(
        context_length=1024, d_model=768, n_heads=12, n_layers=12,
        attention_impl="flash",
    ),
    train=TrainConfig(batch_size=12, train_steps=5000, lr=6e-4, eval_interval=250, eval_iters=20),
)

# GPT-2 350M, data-parallel over every rank.
_register(
    "gpt2-350m-dp",
    _gpt2_model(
        context_length=1024, d_model=1024, n_heads=16, n_layers=24,
        attention_impl="flash",
    ),
    mesh=MeshConfig(data=-1),
    train=TrainConfig(batch_size=32, lr=3e-4),
)

# GPT-2 1.3B, parameters and optimizer state sharded over 8 fsdp ranks.
_register(
    "gpt2-1p3b-fsdp",
    _gpt2_model(
        context_length=1024, d_model=2048, n_heads=16, n_layers=24,
        remat="dots_saveable", attention_impl="flash",
    ),
    mesh=MeshConfig(data=-1, fsdp=8),
    train=TrainConfig(batch_size=64, lr=2e-4, microbatches=2),
)

# Llama-style 1B: RoPE, SwiGLU, RMSNorm, multi-head attention at Dh 128.
_register(
    "llama-1b",
    _llama_model(
        vocab_size=32000,
        context_length=2048,
        d_model=2048,
        n_heads=16,
        n_layers=22,
        mlp_ratio=2.6875,  # d_ff = 5504
        remat="dots_saveable",
        attention_impl="flash",
    ),
    mesh=MeshConfig(data=-1, fsdp=4),
    train=TrainConfig(batch_size=32, lr=3e-4, weight_decay=0.1),
)

# 8k-context pretraining: RoPE, ring attention in the zigzag layout over 4
# seq ranks, sequence parallel, the save_attn remat policy.
_register(
    "gpt2-8k-sp",
    _gpt2_model(
        context_length=8192,
        d_model=768,
        n_heads=12,
        n_layers=12,
        pos_embed="rope",
        attention_impl="ring",
        sequence_parallel=True,
        remat="save_attn",
    ),
    mesh=MeshConfig(data=-1, seq=4),
    train=TrainConfig(batch_size=8, lr=3e-4),
)

# The 8k preset with grouped-query attention: 12 query heads over 3 KV
# heads.
_register(
    "gpt2-8k-gqa",
    _gpt2_model(
        context_length=8192,
        d_model=768,
        n_heads=12,
        n_kv_heads=3,
        n_layers=12,
        pos_embed="rope",
        attention_impl="ring",
        sequence_parallel=True,
        remat="save_attn",
    ),
    mesh=MeshConfig(data=-1, seq=4),
    train=TrainConfig(batch_size=8, lr=3e-4),
)

# The source's own model: 3.16B parameters, ReLU MLP, no attention output
# projection, an untied head with a bias, learned positions.
_register(
    "reference-3b",
    ModelConfig(
        vocab_size=50304,
        context_length=512,
        d_model=2048,
        n_heads=16,
        n_layers=64,
        activation="relu",
        norm="layernorm",
        pos_embed="learned",
        use_output_proj=False,
        tie_embeddings=False,
        lm_head_bias=True,
        qkv_bias=False,
        mlp_bias=True,
        remat="dots_saveable",
        attention_impl="flash",
    ),
    mesh=MeshConfig(data=-1, fsdp=4),
    train=TrainConfig(batch_size=32, train_steps=200_000, lr=1e-4, eval_interval=1000, eval_iters=250),
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
    mesh=MeshConfig(data=-1, fsdp=4),
    train=TrainConfig(batch_size=32, lr=3e-4, weight_decay=0.1),
)

# MoE: 8 experts, top-2 routing, at GPT-2 350M's widths, the experts over
# 4 'expert' ranks (an axis the port does not shard yet: one rank runs it
# with ``mesh.expert=1``, the global batch in ``train.microbatches``).
_register(
    "moe-8x350m",
    _gpt2_model(
        context_length=1024, d_model=1024, n_heads=16, n_layers=24,
        n_experts=8, experts_per_token=2, remat="dots_saveable", attention_impl="flash",
    ),
    mesh=MeshConfig(data=-1, expert=4),
    train=TrainConfig(batch_size=32, lr=3e-4),
)

# Tiny config for tests and smoke runs (byte-level vocabulary).
_register(
    "tiny",
    _gpt2_model(vocab_size=256, context_length=64, d_model=32, n_heads=4, n_layers=2),
    data=DataConfig(tokenizer_name="byte"),
    train=TrainConfig(batch_size=8, train_steps=50, eval_interval=20, eval_iters=2, lr=1e-3),
)


def get_preset(name: str) -> Config:
    if name not in _PRESETS:
        raise KeyError(f"unknown preset {name!r}; available: {sorted(_PRESETS)}")
    return _PRESETS[name]


def list_presets() -> Tuple[str, ...]:
    return tuple(sorted(_PRESETS))
