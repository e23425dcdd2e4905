"""Parallelism on ``torch.distributed``: the rank mesh, the partition rules,
ring (contiguous and zigzag) and Ulysses sequence parallelism, and the
tensor and expert axes' collectives (``tensor``). Counterpart of
``pretraining_llm_tpu/parallel``; the data, fsdp, seq, tensor and expert
axes act, the pipe axis is refused (``mesh.check_ported_axes``)."""

from pretraining_llm_tpu_torch.parallel.mesh import build_mesh, initialize_distributed  # noqa: F401
from pretraining_llm_tpu_torch.parallel.sharding import (  # noqa: F401
    batch_pspec,
    param_pspec_tree,
)
