"""Rank mesh construction and the multi-process bootstrap.

Counterpart of ``pretraining_llm_tpu/parallel/mesh.py`` on
``torch.distributed``. The JAX package asks its runtime for devices and
lays them out as a named ``jax.sharding.Mesh``; here one process drives one
device (a card, or a CPU rank under ``--device cpu``), and the mesh is a
``DeviceMesh`` over the ranks with the same six named axes in the same
order (sized by ``MeshConfig``):

  data   - pure data parallelism (gradient all-reduce)
  fsdp   - data parallelism + parameter/optimizer-state sharding
  tensor - Megatron-style tensor parallelism (``parallel/tensor.py``)
  seq    - sequence/context parallelism (ring attention, Ulysses)
  expert - expert parallelism (``models/moe.py``)
  pipe   - pipeline parallelism (``parallel/pipeline.py``)

The bootstrap is the reference's own (``scripts/train_transformer.py``:
``RANK``/``WORLD_SIZE``/``LOCAL_RANK`` from the launcher, here
``torchrun``): NCCL with ``cuda:LOCAL_RANK`` on the cards, gloo only when
the caller asked for the CPU. A process group the caller made itself is
taken as it is: two ranks can share one card over gloo, whose collectives
then take the CUDA tensors (``mesh_device_type`` says where the ranks'
tensors live, which under gloo is what ``build_mesh`` was told). Rank r
sits at the mesh coordinates of
``arange(world).reshape(sizes)``, the device order of the JAX mesh, so a
rank holds the shard that the JAX mesh gives the device at the same
coordinates (``parallel/sharding.py``).

``axis_group`` gives the process group spanning some axes (the ranks that
differ only in those coordinates), created once per mesh; ``build_mesh``
creates the groups of the train step up front, so every rank creates every
group in the same order.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from pretraining_llm_tpu_torch.config import MeshConfig

# Process groups the train step, the layers, the pipeline and sharded
# inference use, created by ``build_mesh``: the token axes (with pipe where
# the pipe ranks split the columns of the loss), the tensor, expert and
# pipe axes and their combinations (a leaf's squares in the global norm are
# summed over the axes that split it).
_STEP_GROUPS = (("fsdp",), ("seq",), ("data",), ("data", "fsdp"), ("data", "seq"),
                ("data", "fsdp", "seq"), ("tensor",), ("expert",), ("tensor", "expert"),
                ("fsdp", "tensor"), ("fsdp", "expert"), ("fsdp", "tensor", "expert"),
                ("pipe",), ("data", "pipe"), ("fsdp", "pipe"), ("data", "fsdp", "pipe"), ("tensor", "pipe"),
                ("expert", "pipe"), ("fsdp", "tensor", "pipe"), ("fsdp", "expert", "pipe"),
                ("tensor", "expert", "pipe"), ("fsdp", "tensor", "expert", "pipe"))
# Where the ranks' tensors live under gloo: "cpu" unless ``build_mesh`` was
# given a CUDA device.
_GLOO_TENSORS = "cpu"


def initialize_distributed(device: Any = None) -> None:
    """Join the process group ``torchrun`` describes (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``).

    ``device`` is the entry point's device: a CUDA device (the default)
    selects ``cuda:LOCAL_RANK`` and NCCL; ``"cpu"`` gloo. Entry points call
    it first. A single process with no launcher variables, or a process
    that already joined, is a no-op."""
    if not dist.is_available() or dist.is_initialized():
        return
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available for the NCCL process group; pass "
                "device='cpu' (--device cpu) to run the ranks on gloo"
            )
        local = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(local)
        dist.init_process_group("nccl", device_id=local)
    else:
        dist.init_process_group("gloo")


def world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def node_index() -> int:
    """This rank's node (``torchrun``'s group rank): the counterpart of
    the JAX package's process index for data sampling."""
    if "GROUP_RANK" in os.environ:
        return int(os.environ["GROUP_RANK"])
    return rank() // max(1, int(os.environ.get("LOCAL_WORLD_SIZE", world_size())))


def node_count() -> int:
    return max(1, world_size() // max(1, int(os.environ.get("LOCAL_WORLD_SIZE", world_size()))))


def backend() -> Optional[str]:
    """The default process group's backend, or None without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_backend()
    return None


def mesh_device_type() -> str:
    """Where the ranks' tensors live: "cuda" under NCCL; under gloo the
    device type ``build_mesh`` was last given ("cpu" by default, "cuda"
    for ranks that share a card over gloo); "cpu" without a process
    group."""
    name = backend()
    if name == "nccl":
        return "cuda"
    return _GLOO_TENSORS if name == "gloo" else "cpu"


def needs_mesh(mesh_config: MeshConfig) -> bool:
    """Whether training must build a mesh: more than one rank, or any
    configured axis > 1 (the one rule of the trainer and ``train
    --compile-only``). Counts ranks where the JAX package counts
    devices."""
    return world_size() > 1 or any(
        s > 1
        for s in (mesh_config.fsdp, mesh_config.tensor, mesh_config.seq, mesh_config.expert,
                  mesh_config.pipe)
    )


def _world_of_one(device_type: str) -> None:
    """A process group of this process alone, for a mesh of one rank
    without a launcher (an in-process store, no port)."""
    backend = "nccl" if device_type == "cuda" else "gloo"
    kw: Dict[str, Any] = {}
    if device_type == "cuda":
        kw["device_id"] = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1, **kw)


def build_mesh(mesh_config: MeshConfig, device_type: Optional[str] = None) -> Any:
    """The named ``DeviceMesh`` over all ranks, axes in the JAX package's
    order and names. ``device_type`` defaults to the process group's
    ("cuda" under NCCL); a single process without a group gets a world of
    one. Sizes that do not multiply to the world raise ``ValueError`` as
    ``MeshConfig.sizes`` does. Under gloo ``device_type`` "cuda" declares
    that the ranks' tensors live on a card (``mesh_device_type``); the
    ``DeviceMesh`` itself is then the CPU layout of the ranks, since the
    port's collectives run on its own groups (``axis_group``)."""
    global _GLOO_TENSORS
    from torch.distributed.device_mesh import init_device_mesh

    sizes = mesh_config.sizes(world_size())
    if not dist.is_initialized():
        _world_of_one(device_type or "cpu")
    if backend() == "gloo" and device_type is not None:
        _GLOO_TENSORS = torch.device(device_type).type
    device_type = device_type or mesh_device_type()
    layout_type = "cpu" if backend() == "gloo" else device_type
    mesh = init_device_mesh(layout_type, sizes, mesh_dim_names=tuple(mesh_config.axis_names))
    for axes in _STEP_GROUPS:
        axis_group(mesh, axes)
    return mesh


def single_device_mesh(device_type: Optional[str] = None) -> Any:
    """The all-ones mesh of a world of one: for tests and smoke runs."""
    if world_size() != 1:
        raise ValueError(f"single_device_mesh needs a world of one rank, not {world_size()}")
    return build_mesh(MeshConfig(data=1), device_type)


def mesh_shape(mesh: Any) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh``, or of a mapping of axis sizes
    (what the JAX package reads as ``mesh.shape``); {} for None."""
    if mesh is None:
        return {}
    if isinstance(mesh, Mapping):
        return dict(mesh)
    shape = mesh.__dict__.get("_axis_sizes")
    if shape is None:  # DeviceMesh.mesh builds its rank tensor anew on each read
        shape = mesh.__dict__["_axis_sizes"] = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    return dict(shape)


def axis_size(mesh: Any, axis: str) -> int:
    return mesh_shape(mesh).get(axis, 1)


def coordinate(mesh: Any) -> Dict[str, int]:
    """{axis name: this rank's coordinate} on ``mesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


class AxisGroup(NamedTuple):
    """The ranks that differ from this one only along some axes: the
    process group (None when this rank is alone in it), their global ranks
    in the order of their coordinates, and this rank's index there."""

    group: Any
    ranks: Tuple[int, ...]
    index: int

    @property
    def size(self) -> int:
        return len(self.ranks)


def axis_group(mesh: Any, axes: Sequence[str]) -> AxisGroup:
    """The group over ``axes`` of ``mesh`` (cached on the mesh). Every rank
    must ask for a new combination of axes at the same point of its
    program: creating it is a collective over the world."""
    axes = tuple(a for a in mesh.mesh_dim_names if a in axes)
    cache: Dict[Tuple[str, ...], AxisGroup] = mesh.__dict__.setdefault("_axis_groups", {})
    if axes in cache:
        return cache[axes]
    names = list(mesh.mesh_dim_names)
    grid = mesh.mesh
    inside = [names.index(a) for a in axes]
    outside = [i for i in range(len(names)) if i not in inside]
    rows: List[List[int]] = grid.permute(*outside, *inside).reshape(-1, max(1, _prod(grid.shape, inside))).tolist()
    me = dist.get_rank()
    row = next(r for r in rows if me in r)
    if len(row) == dist.get_world_size():
        group = dist.group.WORLD
    elif len(row) == 1:
        group = None
    else:
        group, _ = dist.new_subgroups_by_enumeration(rows)
    out = cache[axes] = AxisGroup(group, tuple(row), row.index(me))
    return out


def _prod(shape: Sequence[int], dims: Sequence[int]) -> int:
    n = 1
    for d in dims:
        n *= int(shape[d])
    return n


def collective_device() -> torch.device:
    """Where a small tensor for a collective lives: the current card when
    the ranks' tensors live on cards (``mesh_device_type``), else the
    CPU."""
    if mesh_device_type() == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_ranks_agree(flag: bool, *, any_of: bool = False) -> bool:
    """Whether ``flag`` holds on every rank (or, with ``any_of``, on some
    rank); a single process returns ``flag``."""
    if world_size() == 1:
        return bool(flag)
    t = torch.tensor([1 if flag else 0], dtype=torch.int32, device=collective_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX if any_of else dist.ReduceOp.MIN)
    return bool(t.item())


def barrier() -> None:
    """Every rank reaches this point (a no-op for a single process)."""
    if world_size() > 1:
        if backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()
