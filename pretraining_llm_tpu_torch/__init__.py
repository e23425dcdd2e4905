"""PyTorch/CUDA port of ``pretraining_llm_tpu``.

The package mirrors the JAX package's layout (``config``, ``models``,
``ops``, ``generation``) so each module's counterpart is easy to find. It
imports torch, numpy and the standard library only, never JAX and nothing
of the JAX package. Every Pallas kernel on a ported path is a CUDA C++
kernel for Hopper (``csrc/``), built at first use by ``ops._build``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
on the CPU every kernel wrapper runs its plain PyTorch version.
"""

from pretraining_llm_tpu_torch.config import Config, ModelConfig, get_preset, list_presets

__all__ = ["Config", "ModelConfig", "get_preset", "list_presets"]
