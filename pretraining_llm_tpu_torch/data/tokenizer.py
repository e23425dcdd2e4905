"""Tokenizer access by name.

Counterpart of ``pretraining_llm_tpu/data/tokenizer.py``:

  ``"byte"``                raw UTF-8 bytes + <|endoftext|> (always available);
  ``"<path>.json"``         a ``BPETokenizer`` saved by either package;
  ``"gpt2"``/``"r50k_base"``  tiktoken's GPT-2 BPE, which needs its data
                            file in tiktoken's cache: without it (offline)
                            this raises ``RuntimeError`` naming the
                            alternatives.

Tokenization runs on the host and never touches the device.
"""

from __future__ import annotations

import functools
from typing import Any

from pretraining_llm_tpu_torch.data.bpe import BPETokenizer, ByteTokenizer


@functools.lru_cache(maxsize=4)
def get_tokenizer(name: str = "gpt2") -> Any:
    if name == "byte":
        return ByteTokenizer()
    if name.endswith(".json"):
        return BPETokenizer.load(name)
    if name in ("gpt2", "r50k_base"):
        try:
            import tiktoken

            return tiktoken.get_encoding("gpt2")
        except Exception as e:  # not installed, or offline and uncached
            raise RuntimeError(
                "tiktoken could not load the GPT-2 BPE data (offline without a "
                "TIKTOKEN_CACHE_DIR cache). Use tokenizer_name='byte', or train "
                "an in-repo BPE (pretraining_llm_tpu_torch.data.bpe.BPETokenizer.train) "
                "and pass its .json path as tokenizer_name."
            ) from e
    raise ValueError(f"unknown tokenizer {name!r}")
