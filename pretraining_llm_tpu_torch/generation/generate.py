"""KV-cached autoregressive generation from a dense cache.

Counterpart of ``pretraining_llm_tpu/generation/generate.py``: one prefill
over the prompt (padded to ``_bucket_len``'s bucket, so cache slots and
positions equal the JAX package's slot for slot; a MoE model's prompt is
not padded and its rows must be of one length), then single-token decode
steps against the cache. Where JAX scans the decode steps inside one
compiled program, the port runs a host loop over them; the tokens stay on
the device between steps, so the loop never waits for the card. Random
draws come from one ``torch.Generator`` seeded from ``seed``: greedy
decoding gives the JAX package's tokens, sampled streams agree in
distribution only.

On the card the prefill runs the flash forward kernel (K1) once per layer;
the decode steps attend with masked attention over the cache in torch ops,
as the JAX package's decode is plain XLA.

``generate_text`` / ``generate_text_batch`` mirror the JAX CLI surface:
load a checkpoint of either package (``load_model_for_inference``), cast
the matmul weights once (``cast_params_for_inference``), encode, generate,
decode. ``generate_text_speculative`` decodes with a draft checkpoint
(``generation/speculative.py``).

Sharded decode: ``shard_params_for_inference(params, mesh)`` gives each
rank its blocks under the training partition rules (the JAX package's,
with the mesh's tensor size), and ``generate(..., mesh=)`` runs every rank
through the same loop on the same rows: fsdp blocks are gathered once for
use, the tensor-parallel layers issue their collectives as in training,
the head's logits are gathered over 'tensor' before sampling, and every
rank samples from the same seeded generator, so all ranks hold the same
tokens.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from pretraining_llm_tpu_torch.config import Config, ModelConfig
from pretraining_llm_tpu_torch.data.tokenizer import get_tokenizer
from pretraining_llm_tpu_torch.generation.sampling import sample_logits
from pretraining_llm_tpu_torch.models import transformer
from pretraining_llm_tpu_torch.models.bridge import cast_params_for_inference
from pretraining_llm_tpu_torch.models.quantize import scale_shape
from pretraining_llm_tpu_torch.parallel.mesh import axis_group, axis_size
from pretraining_llm_tpu_torch.parallel.sharding import (
    _entry_axes, activation_mesh, is_sharded, param_pspec, param_pspec_tree, shard_leaf, shard_tree,
)
from pretraining_llm_tpu_torch.parallel.tensor import gather_dim
from pretraining_llm_tpu_torch.training import checkpoint as ckpt
from pretraining_llm_tpu_torch.utils.device import DeviceLike, resolve_device

__all__ = [
    "cast_params_for_inference", "decode_bench_workload", "generate", "generate_text", "generate_text_batch",
    "generate_text_speculative", "load_model_for_inference", "shard_params_for_inference",
]


def _bucket_len(prompt_len: int, ctx: int, max_new_tokens: int) -> int:
    """Pad target of the prompt, the JAX package's rule: the next power of
    two (>= 16), capped so that the padded prompt and the generation fit
    the context."""
    b = 16
    while b < prompt_len:
        b *= 2
    return max(prompt_len, min(b, ctx - max_new_tokens))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def decode_bench_workload(cfg: ModelConfig, batch: int, *, quick: bool = False,
                          device: DeviceLike = None) -> Tuple[ModelConfig, Any, torch.Tensor, int]:
    """The decode measurement's workload, the JAX package's: (cfg, params,
    prompt, new_tokens). Ring and Ulysses attention fall back to the cached
    naive path; the params are ``init_params`` from seed 0, cast for
    inference; the prompt is (batch, prompt_len) tokens from a generator
    seeded with 1, prompt_len = min(64, ctx - new_tokens)."""
    dev = resolve_device(device)
    if cfg.attention_impl in ("ring", "ulysses"):
        cfg = dataclasses.replace(cfg, attention_impl="naive", sequence_parallel=False)
    new_tokens = min(64 if quick else 256, cfg.context_length // 2)
    prompt_len = min(64, cfg.context_length - new_tokens)
    params = cast_params_for_inference(transformer.init_params(cfg, 0, device=dev), cfg)
    prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len), generator=torch.Generator().manual_seed(1))
    return cfg, params, prompt.to(dev), new_tokens


def generate(
    params: Any,
    cfg: ModelConfig,
    prompt_tokens: Any,
    max_new_tokens: int,
    seed: Union[int, torch.Generator] = 0,
    *,
    temperature: float = 1.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    min_p: Optional[float] = None,
    mesh: Any = None,
    prompt_lengths: Optional[Any] = None,
    stop_token: Optional[int] = None,
    stats: Optional[Dict[str, float]] = None,
    return_logits: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Continuations of ``prompt_tokens`` ((B, P) or (P,) ints) on the
    params' device: (B, max_new_tokens) int32.

    ``prompt_lengths`` ((B,) ints) makes the rows ragged: right-padded to P
    on input, prefilled right-padded, then each row's cache is rolled right
    so every prompt ends at slot bucket-1 and the batch decodes in lockstep
    with per-row ``pad_offsets``. ``stop_token``: a row that emits it keeps
    emitting it (the caller strips the tail). ``stats``, when given, is
    filled with the prefill's and the decode loop's wall seconds (each
    ended by a device synchronize) and the tokens each one computed (the
    real prompt tokens; rows x decode forwards). ``return_logits`` also
    returns the fp32 logits (B, max_new_tokens, V) each token was drawn
    from. ``mesh``: every rank runs the call with its blocks of the
    parameters (``shard_params_for_inference``'s, or full ones, which are
    cut to them) and the same arguments, and returns the same tokens."""
    if mesh is not None:
        local = mesh_params(params, cfg, mesh)
        with activation_mesh(mesh, rows_split=False):
            return generate(local, cfg, prompt_tokens, max_new_tokens, seed, temperature=temperature,
                            top_k=top_k, top_p=top_p, min_p=min_p, prompt_lengths=prompt_lengths,
                            stop_token=stop_token, stats=stats, return_logits=return_logits)
    if cfg.doc_mask_token >= 0:
        # Document masking is a training structure; one generation is one
        # document, so the mask is vacuous (forward refuses it with a cache).
        cfg = dataclasses.replace(cfg, doc_mask_token=-1)
    device = params["tok_embed"]["embedding"].device
    if torch.is_tensor(prompt_tokens):
        prompt = prompt_tokens.to(device=device, dtype=torch.long)
    else:
        prompt = torch.as_tensor(np.asarray(prompt_tokens, np.int64), device=device)
    prompt = torch.atleast_2d(prompt)
    b, prompt_len = prompt.shape
    if prompt_len + max_new_tokens > cfg.context_length:
        raise ValueError(
            f"prompt({prompt_len}) + max_new_tokens({max_new_tokens}) exceeds "
            f"context_length={cfg.context_length}"
        )
    lengths = None
    if prompt_lengths is not None:
        if cfg.n_experts:
            raise ValueError(
                "ragged prompt_lengths is unsupported for MoE models: left-"
                "pad slots would compete for expert capacity during prefill"
            )
        lengths = np.asarray(prompt_lengths, np.int64).reshape(-1)
        if lengths.shape[0] != b:
            raise ValueError(f"prompt_lengths has {lengths.shape[0]} rows for a batch of {b}")
        if int(lengths.max()) > prompt_len or int(lengths.min()) < 1:
            raise ValueError("prompt_lengths must lie in [1, P] for (B, P) prompt_tokens")
    # A MoE prefill routes with a capacity proportional to its token count,
    # and pad tokens would compete for expert slots: no bucket padding.
    bucket = prompt_len if cfg.n_experts else _bucket_len(prompt_len, cfg.context_length, max_new_tokens)
    total = bucket + max_new_tokens
    if bucket > prompt_len:
        prompt = torch.nn.functional.pad(prompt, (0, bucket - prompt_len))
    if isinstance(seed, torch.Generator):
        gen = seed
    else:
        gen = torch.Generator(device=device).manual_seed(int(seed))
    sample_kw = dict(temperature=temperature, top_k=top_k, top_p=top_p, min_p=min_p)

    t0 = time.perf_counter()
    cache = transformer.make_kv_cache(cfg, b, total, device=device)
    with torch.no_grad():
        # Prefill over the right-padded prompt: causality keeps the pads
        # invisible to real tokens, and each pad slot is overwritten by the
        # decoded token that lands there before the kv mask exposes it.
        logits, cache = transformer.forward(params, prompt, cfg, kv_cache=cache, cache_index=0)
        pad_off = None
        if lengths is None:
            last = logits[:, prompt_len - 1]
        else:
            lens = torch.as_tensor(lengths, device=device)
            last = logits[torch.arange(b, device=device), lens - 1]
            # Roll each row right so its prompt ends at slot bucket-1; slots
            # below its offset hold copies the decode mask never exposes.
            pad_off = bucket - lens
            src = (torch.arange(total, device=device)[None, :] - pad_off[:, None]).clamp(0, total - 1)
            cache = {name: torch.take_along_dim(buf, src[None, :, :, None, None], dim=2)
                     for name, buf in cache.items()}
        tok = sample_logits(last, gen, **sample_kw)
        step_logits = [last] if return_logits else None
        if stats is not None:
            _sync(device)
            t1 = time.perf_counter()
            stats.update(prefill_s=t1 - t0, prefill_tokens=float(lengths.sum() if lengths is not None
                                                                 else b * prompt_len))
        stop = None if stop_token is None else torch.tensor(stop_token, dtype=torch.int32, device=device)
        out = []
        index = prompt_len if lengths is None else bucket
        for step in range(max_new_tokens):
            out.append(tok)
            if step == max_new_tokens - 1:
                break  # the next token would go unused
            logits, cache = transformer.forward(
                params, tok[:, None], cfg, kv_cache=cache, cache_index=index, pad_offsets=pad_off,
            )
            nxt = sample_logits(logits[:, 0], gen, **sample_kw)
            if step_logits is not None:
                step_logits.append(logits[:, 0])
            if stop is not None:
                nxt = torch.where(tok == stop, stop, nxt)
            tok = nxt
            index += 1
        result = torch.stack(out, dim=1) if out else torch.zeros((b, 0), dtype=torch.int32, device=device)
    if stats is not None:
        _sync(device)
        stats.update(decode_s=time.perf_counter() - t1, decode_tokens=float(b * (max_new_tokens - 1)))
    if return_logits:
        return result, torch.stack(step_logits, dim=1)
    return result


def shard_params_for_inference(params: Any, mesh: Any) -> Any:
    """This rank's blocks of the full ``params`` under the training
    partition rules (TP/FSDP, int8 ``_scale`` leaves with their weights)
    at the mesh's tensor size: the pieces that the JAX package's
    ``NamedSharding``s give the device at the rank's coordinates."""
    return shard_tree(params, param_pspec_tree(params, tensor_size=axis_size(mesh, "tensor")), mesh)


def _full_shape(shapes: Any, path: Tuple[str, ...]) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """(the full shape of the leaf at ``path``, the shape its spec rule
    reads): an int8 ``_scale`` leaf's are its weight's with the contracted
    axes collapsed, and its weight's."""
    name = path[-1]
    base = name[:-len("_scale")] if name.endswith("_scale") and path[-2] in ("attn", "mlp") else name
    tree = shapes
    for k in path[:-1] + (base,):
        tree = tree[k]
    full = tuple(tree)
    return (scale_shape(base, full) if base != name else full), full


def mesh_params(params: Any, cfg: ModelConfig, mesh: Any) -> Any:
    """The parameters a rank's sharded forward takes: its tensor and
    expert blocks, with fsdp blocks all-gathered. Each leaf may come full
    (it is cut to the rank's block) or as ``shard_params_for_inference``'s
    block (its fsdp dims are gathered)."""
    shapes = transformer.param_shapes(cfg)
    tp = axis_size(mesh, "tensor")
    fsdp = axis_group(mesh, ("fsdp",))

    def walk(tree: Any, path: Tuple[str, ...]) -> Any:
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        full, rule_shape = _full_shape(shapes, path)
        spec = param_pspec(path, len(full), shape=rule_shape, tensor_size=tp)
        if not is_sharded(spec, mesh):
            return tree
        if tuple(tree.shape) == full:  # a full leaf: the rank's block, whole over fsdp
            keep = tuple(tuple(a for a in _entry_axes(e) if a != "fsdp") or None for e in spec)
            return shard_leaf(tree, keep, mesh, "/".join(path))
        for d, entry in enumerate(spec):
            if "fsdp" in _entry_axes(entry) and fsdp.size > 1:
                tree = gather_dim(tree, d, fsdp)
        return tree

    return walk(params, ())


# ---------------------------------------------------------------------------
# Checkpoint-driven text generation (CLI surface)
# ---------------------------------------------------------------------------


def load_model_for_inference(
    model_path: str, *, use_ema: bool = False, device: DeviceLike = None,
) -> Tuple[Dict[str, Any], Config]:
    """(params, config) from a checkpoint of either package: ``model_path``
    is a ``step-N`` directory or a run directory (its latest step). The
    config comes from the checkpoint's metadata. ``use_ema`` loads the EMA
    shadow. Params keep their checkpoint dtypes (callers that only run the
    forward apply ``cast_params_for_inference``) and go to ``device``."""
    dev = resolve_device(device)
    path = model_path
    if not os.path.basename(path.rstrip("/")).startswith("step-"):
        latest = ckpt.latest_checkpoint(path)
        if latest is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
        path = latest
    with open(os.path.join(path, "metadata.json")) as f:
        meta = json.load(f)
    cfg = Config.from_dict(meta["extra"]["config"])
    key = "ema" if use_ema else "params"

    def meta_tree(tree: Dict[str, Any]) -> Dict[str, Any]:
        return {k: meta_tree(v) if isinstance(v, dict) else torch.empty(v, device="meta")
                for k, v in tree.items()}

    template = {key: meta_tree(transformer.param_shapes(cfg.model))}
    try:
        restored, _ = ckpt.load_checkpoint(path, template)
    except ValueError as e:
        if use_ema and "missing leaves" in str(e):
            raise ValueError(
                f"checkpoint {path} has no EMA shadow (the run trained "
                "with train.ema_decay=0); drop --ema or retrain with "
                "ema_decay > 0"
            ) from e
        raise

    def to_device(tree: Dict[str, Any]) -> Dict[str, Any]:
        return {k: to_device(v) if isinstance(v, dict) else v.to(dev) for k, v in tree.items()}

    return to_device(restored[key]), cfg


def generate_text(
    model_path: str,
    input_text: str,
    max_new_tokens: int = 100,
    *,
    temperature: float = 1.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    min_p: Optional[float] = None,
    seed: int = 0,
    tokenizer: Optional[str] = None,
    stop_token: Optional[int] = None,
    ema: bool = False,
    device: DeviceLike = None,
) -> str:
    """Checkpoint -> the text's continuation (``generate_text_batch`` of one
    prompt). ``tokenizer`` overrides the name in the checkpoint's config."""
    return generate_text_batch(
        model_path, [input_text], max_new_tokens, temperature=temperature, top_k=top_k,
        top_p=top_p, min_p=min_p, seed=seed, tokenizer=tokenizer, stop_token=stop_token,
        ema=ema, device=device,
    )[0]


def generate_text_batch(
    model_path: str,
    input_texts: Sequence[str],
    max_new_tokens: int = 100,
    *,
    temperature: float = 1.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    min_p: Optional[float] = None,
    seed: int = 0,
    tokenizer: Optional[str] = None,
    stop_token: Optional[int] = None,
    ema: bool = False,
    device: DeviceLike = None,
) -> List[str]:
    """Continuations of different-length prompts in one ragged batch: one
    string per input, each the prompt followed by its continuation, cut
    before (excluding) the row's first ``stop_token``."""
    if not input_texts:
        raise ValueError("input_texts is empty (nothing to generate)")
    params, cfg = load_model_for_inference(model_path, use_ema=ema, device=device)
    params = cast_params_for_inference(params, cfg.model)
    enc = get_tokenizer(tokenizer or cfg.data.tokenizer_name)
    encoded = [np.asarray(enc.encode_ordinary(t), np.int64) for t in input_texts]
    empty = [i for i, e in enumerate(encoded) if len(e) == 0]
    if empty:
        raise ValueError(
            f"prompts at indices {empty} encode to zero tokens; ragged "
            "decode needs at least one real token per row"
        )
    lengths = np.asarray([len(e) for e in encoded], np.int64)
    batch = np.zeros((len(encoded), int(lengths.max())), np.int64)
    for i, e in enumerate(encoded):
        batch[i, : len(e)] = e
    uniform = bool((lengths == lengths[0]).all())
    if cfg.model.n_experts and not uniform:
        raise ValueError(
            "MoE models require equal-length prompts per batch (ragged "
            "left-pad slots would compete for expert capacity); generate "
            "each prompt separately or group by length"
        )
    out = generate(
        params, cfg.model, batch, max_new_tokens, seed, temperature=temperature, top_k=top_k,
        top_p=top_p, min_p=min_p, prompt_lengths=None if uniform else lengths,
        stop_token=stop_token,
    ).cpu().numpy()

    def ids(row: np.ndarray) -> List[int]:
        toks = row.tolist()
        if stop_token is not None and stop_token in toks:
            toks = toks[: toks.index(stop_token)]
        return toks

    return [t + enc.decode(ids(out[i])) for i, t in enumerate(input_texts)]


def generate_text_speculative(
    model_path: str,
    draft_model_path: str,
    input_text: str,
    max_new_tokens: int = 100,
    *,
    k: int = 4,
    temperature: float = 0.0,
    seed: int = 0,
    tokenizer: Optional[str] = None,
    device: DeviceLike = None,
) -> str:
    """Speculative continuation: a draft checkpoint proposes ``k`` tokens a
    round and the target verifies them in one forward
    (``speculative.generate_speculative``; greedy output equals the
    target's alone). Both checkpoints must share a vocabulary. Prints the
    acceptance to stderr, as the JAX package does."""
    import sys

    from pretraining_llm_tpu_torch.generation.speculative import generate_speculative

    params_t, cfg_t = load_model_for_inference(model_path, device=device)
    params_d, cfg_d = load_model_for_inference(draft_model_path, device=device)
    params_t = cast_params_for_inference(params_t, cfg_t.model)
    params_d = cast_params_for_inference(params_d, cfg_d.model)
    enc = get_tokenizer(tokenizer or cfg_t.data.tokenizer_name)
    prompt = np.asarray(enc.encode_ordinary(input_text), np.int64)
    if len(prompt) == 0:
        raise ValueError("prompt encodes to zero tokens")
    out, stats = generate_speculative(
        params_t, cfg_t.model, params_d, cfg_d.model, prompt[None], max_new_tokens, seed,
        k=k, temperature=temperature,
    )
    rate = stats["accepted"] / max(stats["proposed"], 1)
    print(
        f"[speculative] rounds={stats['rounds']} "
        f"acceptance={stats['accepted']}/{stats['proposed']} ({rate:.0%})",
        file=sys.stderr,
    )
    return input_text + enc.decode(out.cpu().tolist())
