"""Partition rules: parameter tree paths -> specs over the named mesh.

Counterpart of ``pretraining_llm_tpu/parallel/sharding.py``. A spec is a
tuple with one entry per dimension of a leaf: None (not split), an axis
name, or a tuple of axis names (split over their product, the first
slowest), the entries of JAX's ``PartitionSpec``. ``param_pspec`` and
``param_pspec_tree`` are JAX's rules, rule for rule, over the port's tree
(the same names and stacked layout):

  - FSDP/ZeRO-3: every large matrix shards one dimension over 'fsdp'
    (parameters and AdamW's moments: the spec tree is reused for both);
  - Megatron TP: heads, the MLP hidden dim and the vocabulary over
    'tensor' (the layers' collectives are ``parallel/tensor.py``'s); the
    MoE experts' leading dim over 'expert';
  - norm scales and biases are replicated.

Where JAX lets XLA place each leaf, the port places it itself:
``local_slices`` is the rank's slice of a leaf under a spec, the block the
JAX mesh gives the device at the same coordinates, for a leaf split over
one axis or over several at once (``wqkv`` is fsdp x tensor, an expert's
``w1`` expert x fsdp x tensor); it stands for JAX's
``named_sharding_tree``, which has no counterpart here. Where a dimension
does not divide its axes, the port raises ``ValueError`` naming the leaf
and the axes, as JAX's ``device_put`` refuses the uneven shard.

``activation_mesh``/``current_mesh`` install the mesh the model reads
(ring and Ulysses attention, the zigzag layout of ``loss_fn``). JAX's
``constrain`` is a layout hint to XLA that changes no value; the port
leaves it out (each rank already holds exactly its block).
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Iterator, Optional, Tuple, Union

import torch

from pretraining_llm_tpu_torch.parallel.mesh import coordinate, mesh_shape

Spec = Tuple[Union[None, str, Tuple[str, ...]], ...]


def P(*spec: Any) -> Spec:
    """A spec: one entry per dimension."""
    return tuple(spec)


def param_pspec(
    path_names: Tuple[str, ...],
    ndim: int,
    pipeline: bool = False,
    *,
    shape: Optional[Tuple[int, ...]] = None,
    tensor_size: int = 1,
) -> Spec:
    """Spec for one parameter, keyed on its pytree path.

    Parameters under 'blocks' are stacked with a leading n_layers dim (scanned
    by the model). Without pipelining that dim is never sharded (leading None);
    with ``pipeline=True`` it shards over 'pipe' (stage assignment IS the
    sharding) composed with the per-weight expert/tensor/fsdp dims.

    ``shape``/``tensor_size`` feed shape-dependent rules: the GQA KV
    projection shards its G head dim over 'tensor' only when G divides
    evenly (see the ``wkv`` rule).
    """
    name = path_names[-1]
    parent = path_names[-2] if len(path_names) >= 2 else ""
    in_blocks = "blocks" in path_names

    if pipeline and in_blocks:
        base = tuple(
            param_pspec(
                path_names, ndim, pipeline=False, shape=shape, tensor_size=tensor_size
            )
        )
        base = base + (None,) * (ndim - len(base))  # P() drops trailing Nones
        return P("pipe", *base[1:])

    def blk(*spec: Optional[str]) -> Spec:
        return P(None, *spec) if in_blocks else P(*spec)

    if "experts" in path_names:
        # MoE expert FFNs: leading E dim over 'expert', matrices TP+FSDP like
        # their dense counterparts (column-parallel w1, row-parallel w2).
        if name == "w1":  # (E, D, F) or (E, D, 2, F) swiglu
            if ndim - (1 if in_blocks else 0) == 4:
                return blk("expert", "fsdp", None, "tensor")
            return blk("expert", "fsdp", "tensor")
        if name == "b1":  # (E, F) or (E, 2, F)
            if ndim - (1 if in_blocks else 0) == 3:
                return blk("expert", None, "tensor")
            return blk("expert", "tensor")
        if name == "w2":  # (E, F, D)
            return blk("expert", "tensor", "fsdp")
        if name == "b2":  # (E, D)
            return blk("expert", None)
    if name == "router":  # (D, E)
        return blk("fsdp", None)
    if name == "embedding":
        if parent == "tok_embed":
            return P("tensor", "fsdp")  # (V, D): vocab TP, dim FSDP
        return P(None, "fsdp")  # (T, D) learned positions
    if parent in ("ln1", "ln2", "final_norm") or name in ("scale",):
        return blk(*([None] * (ndim - (1 if in_blocks else 0))))
    if name.endswith("_scale") and parent in ("attn", "mlp"):
        # int8 weight scales (models/quantize.py): shaped like their
        # weight with the contracted (input) dims collapsed to 1 — shard
        # the surviving output dims exactly as the weight rule does so a
        # TP rank holds precisely its output channels' scales; singleton
        # input dims replicate.
        base = name[: -len("_scale")]
        if base == "wqkv":  # (1, 3, H, Dh)
            return blk(None, None, "tensor", None)
        if base == "wq":  # (1, H, Dh)
            return blk(None, "tensor", None)
        if base == "wkv":  # (1, 2, G, Dh): follows wkv's G-dim decision
            g = shape[-2] if shape else 0
            if tensor_size > 1 and g % tensor_size == 0:
                return blk(None, None, "tensor", None)
            return blk(None, None, None, None)
        if base == "wo":  # (1, 1, D)
            return blk(None, None, "fsdp")
        if base == "w1":  # (1, F) or (1, 2, F) swiglu
            if ndim - (1 if in_blocks else 0) == 3:
                return blk(None, None, "tensor")
            return blk(None, "tensor")
        if base == "w2":  # (1, D)
            return blk(None, "fsdp")
        # Unknown quantized weight: replicate.
        return P(*([None] * ndim))
    if name == "wqkv":  # (D, 3, H, Dh): column-parallel over heads
        return blk("fsdp", None, "tensor", None)
    if name == "bqkv":  # (3, H, Dh)
        return blk(None, "tensor", None)
    if name == "wq":  # (D, H, Dh) — GQA query projection
        return blk("fsdp", "tensor", None)
    if name == "bq":  # (H, Dh)
        return blk("tensor", None)
    if name == "wkv":
        # (D, 2, G, Dh) — GQA kv projection. Shard the G head dim over
        # 'tensor' when it divides evenly; otherwise (MQA G=1, or G=8 on
        # tp=3) keep it replicated.
        g = shape[-2] if shape else 0
        if tensor_size > 1 and g % tensor_size == 0:
            return blk("fsdp", None, "tensor", None)
        return blk("fsdp", None, None, None)
    if name == "bkv":  # (2, G, Dh): follows wkv's G-dim decision
        g = shape[-2] if shape else 0
        if tensor_size > 1 and g % tensor_size == 0:
            return blk(None, "tensor", None)
        return blk(None, None, None)
    if name == "wo":  # (H, Dh, D): row-parallel
        return blk("tensor", None, "fsdp")
    if name == "bo":  # (D,)
        return blk(None)
    if name == "w1":  # (D, F) or (D, 2, F) for swiglu: column-parallel
        if ndim - (1 if in_blocks else 0) == 3:
            return blk("fsdp", None, "tensor")
        return blk("fsdp", "tensor")
    if name == "b1":  # (F,) or (2, F)
        if ndim - (1 if in_blocks else 0) == 2:
            return blk(None, "tensor")
        return blk("tensor")
    if name == "w2":  # (F, D): row-parallel
        return blk("tensor", "fsdp")
    if name == "b2":  # (D,)
        return blk(None)
    if name == "kernel" and parent == "lm_head":  # (D, V)
        return P("fsdp", "tensor")
    if name == "bias" and parent == "lm_head":  # (V,)
        return P("tensor")
    if name == "bias":  # norm biases and any other small bias: replicate
        return blk(*([None] * (ndim - (1 if in_blocks else 0))))
    # Fallback: shard nothing rather than guess wrong.
    return P(*([None] * ndim))


def param_pspec_tree(params: Any, pipeline: bool = False, *, tensor_size: int = 1) -> Any:
    """Map a parameter (or optimizer-moment) tree to a tree of specs.
    ``tensor_size`` is the mesh's 'tensor' extent (it gates the GQA ``wkv``
    head rule)."""

    def walk(tree: Any, path: Tuple[str, ...]) -> Any:
        if isinstance(tree, dict):
            return {k: walk(v, path + (str(k),)) for k, v in tree.items()}
        shape = tuple(getattr(tree, "shape", ()))
        return param_pspec(path, len(shape), pipeline, shape=shape or None, tensor_size=tensor_size)

    return walk(params, ())


def batch_pspec(sequence_parallel: bool = False) -> Spec:
    """Spec for (B, T) token batches: batch over data+fsdp, seq over 'seq'."""
    return P(("data", "fsdp"), "seq" if sequence_parallel else None)


# ---------------------------------------------------------------------------
# The rank's share of a leaf
# ---------------------------------------------------------------------------


def _entry_axes(entry: Any) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def split_count(entry: Any, mesh: Any) -> int:
    """How many ways one spec entry splits its dimension on ``mesh``."""
    shape = mesh_shape(mesh)
    n = 1
    for a in _entry_axes(entry):
        n *= shape.get(a, 1)
    return n


def is_sharded(spec: Spec, mesh: Any) -> bool:
    """Whether a leaf under ``spec`` is split at all on ``mesh``."""
    return any(split_count(e, mesh) > 1 for e in spec)


def local_slices(spec: Spec, shape: Tuple[int, ...], mesh: Any,
                 coord: Optional[Dict[str, int]] = None, name: str = "a leaf") -> Tuple[slice, ...]:
    """This rank's block of a leaf of ``shape`` under ``spec``: dimension d
    is cut into ``split_count`` equal blocks, and the rank takes the block
    of its coordinates on the entry's axes (the first axis slowest), as a
    ``NamedSharding`` does. ``coord`` (default: this rank's on ``mesh``)
    names other coordinates; a dimension that does not divide raises
    ``ValueError`` naming ``name`` and the axes."""
    shape = tuple(int(s) for s in shape)
    sizes = mesh_shape(mesh)
    if coord is None:
        coord = coordinate(mesh) if any(split_count(e, mesh) > 1 for e in spec) else {}
    out = []
    for d, dim in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        n = split_count(entry, mesh)
        if n == 1:
            out.append(slice(0, dim))
            continue
        if dim % n:
            raise ValueError(
                f"{name}: dimension {d} of size {dim} does not split evenly over mesh axis "
                f"{'x'.join(_entry_axes(entry))} ({n} ways; spec {spec}); the port shards only even "
                "splits")
        k = 0
        for a in _entry_axes(entry):
            k = k * sizes.get(a, 1) + coord.get(a, 0)
        block = dim // n
        out.append(slice(k * block, (k + 1) * block))
    return tuple(out)


def shard_leaf(x: torch.Tensor, spec: Spec, mesh: Any, name: str = "a leaf") -> torch.Tensor:
    """This rank's block of the full leaf ``x`` (a fresh contiguous tensor
    when it is a part; ``x`` itself when the spec splits nothing)."""
    if not is_sharded(spec, mesh):
        return x
    return x[local_slices(spec, tuple(x.shape), mesh, name=name)].contiguous().clone()


def shard_tree(tree: Any, specs: Any, mesh: Any, path: Tuple[str, ...] = ()) -> Any:
    """Each leaf of a nested dict replaced by this rank's block under the
    matching spec of ``specs``."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, specs[k], mesh, path + (k,)) for k, v in tree.items()}
    return shard_leaf(tree, specs, mesh, "/".join(path))


# ---------------------------------------------------------------------------
# The active mesh
# ---------------------------------------------------------------------------
# The model is mesh-agnostic; the train step installs the active mesh here
# so attention and ``loss_fn`` can read its seq axis. Outside a mesh context
# ``current_mesh()`` is None and every path is the single-rank one.

_CURRENT_MESH: Optional[Any] = None
_ROWS_SPLIT = True


@contextlib.contextmanager
def activation_mesh(mesh: Optional[Any], *, rows_split: bool = True) -> Iterator[None]:
    """Install ``mesh`` for the model. ``rows_split`` says whether the
    ranks of a data x fsdp group hold different rows (a train or eval
    step: the MoE router's statistics then span the ranks) or the same
    ones (sharded inference: every rank runs the same rows)."""
    global _CURRENT_MESH, _ROWS_SPLIT
    prev = _CURRENT_MESH, _ROWS_SPLIT
    _CURRENT_MESH, _ROWS_SPLIT = mesh, rows_split
    try:
        yield
    finally:
        _CURRENT_MESH, _ROWS_SPLIT = prev


def current_mesh() -> Optional[Any]:
    return _CURRENT_MESH


def sequence_shards(cfg: Any, mesh: Any) -> int:
    """How many seq ranks split each row's tokens under ``mesh``: the seq
    axis when the model's attention (``cfg.attention_impl``) is ring or
    Ulysses over it, else 1 (the seq ranks then compute the same full rows,
    as JAX's global view does)."""
    if mesh is None or cfg.attention_impl not in ("ring", "ulysses"):
        return 1
    return mesh_shape(mesh).get("seq", 1)


def rows_split() -> bool:
    """Whether the active mesh's data x fsdp ranks hold different rows."""
    return _CURRENT_MESH is not None and _ROWS_SPLIT
