"""Parallelism on ``torch.distributed``: the rank mesh, the partition rules,
ring (contiguous and zigzag) and Ulysses sequence parallelism, the tensor
and expert axes' collectives (``tensor``) and the pipeline over the pipe
axis (``pipeline``). Counterpart of ``pretraining_llm_tpu/parallel``; all
six axes act."""

from pretraining_llm_tpu_torch.parallel.mesh import build_mesh, initialize_distributed  # noqa: F401
from pretraining_llm_tpu_torch.parallel.sharding import (  # noqa: F401
    batch_pspec,
    param_pspec_tree,
)
