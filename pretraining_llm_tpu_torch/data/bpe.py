"""Byte-level tokenizers with tiktoken's surface: bytes, and a trainable BPE.

Counterpart of ``pretraining_llm_tpu/data/bpe.py``:

  - ``ByteTokenizer``: raw UTF-8 bytes and an ``<|endoftext|>`` id (256).
  - ``BPETokenizer``: byte-level BPE with an explicit merge list, trained
    on a corpus (``train``), saved and loaded as the JAX package's JSON
    (``{"merges": [[a, b], ...], "special_tokens": {...}}``), so either
    package loads the other's file. ``encode_ordinary`` applies merges
    lowest rank first; ``decode`` maps ids back to bytes.

Encoding runs on the host, never on the device. It takes the native
encoder (``csrc/bpe.cpp`` through ``data/native_bpe.py``) when it builds,
else the Python sweep, as the JAX package does; both give the same ids.
The choice is logged once per tokenizer and kept in ``encoder``.
"""

from __future__ import annotations

import json
import logging
from collections import Counter
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from pretraining_llm_tpu_torch.data.native_bpe import NativeBpeEncoder

_log = logging.getLogger(__name__)


class ByteTokenizer:
    """UTF-8 bytes as tokens; id 256 is <|endoftext|>."""

    n_vocab = 257

    @property
    def eot_token(self) -> int:
        return 256

    def encode_ordinary(self, text: str) -> List[int]:
        return list(text.encode("utf-8"))

    def encode(self, text: str) -> List[int]:
        return self.encode_ordinary(text)

    def decode(self, ids: Sequence[int]) -> str:
        return bytes(i for i in ids if i < 256).decode("utf-8", errors="replace")


class BPETokenizer:
    """Byte-level BPE: ids 0..255 are bytes, 256+i is merge i, then the
    special tokens."""

    def __init__(self, merges: List[Tuple[int, int]], special_tokens: Optional[Dict[str, int]] = None):
        self.merges = [tuple(m) for m in merges]
        self.ranks: Dict[Tuple[int, int], int] = {m: i for i, m in enumerate(self.merges)}
        self.special_tokens = special_tokens or {"<|endoftext|>": 256 + len(self.merges)}
        self._decode_table: Dict[int, bytes] = {i: bytes([i]) for i in range(256)}
        for i, (a, b) in enumerate(self.merges):
            self._decode_table[256 + i] = self._decode_table[a] + self._decode_table[b]
        self._native = None  # the native encoder, or False once it failed to load
        self.encoder: Optional[str] = None  # "native" or "python", once chosen

    @property
    def n_vocab(self) -> int:
        return 256 + len(self.merges) + len(self.special_tokens)

    @property
    def eot_token(self) -> int:
        return self.special_tokens["<|endoftext|>"]

    def _choose_encoder(self) -> None:
        try:
            self._native = NativeBpeEncoder(self.merges)
            self.encoder = "native"
            _log.info("BPE encoder: native (csrc/bpe.cpp), %d merges", len(self.merges))
        except RuntimeError as e:
            self._native = False
            self.encoder = "python"
            _log.warning("BPE encoder: the Python sweep (%s)", e)

    def encode_ordinary(self, text: str) -> List[int]:
        data = text.encode("utf-8")
        if not self.ranks:
            return list(data)
        if self._native is None:
            self._choose_encoder()
        if self._native:
            return self._native.encode_bytes(data)
        return self._encode_python(list(data))

    def _encode_python(self, ids: List[int]) -> List[int]:
        """The greedy sweep: merge every occurrence of the lowest-rank
        adjacent pair, left to right, until none is left. The oracle of the
        native encoder."""
        while len(ids) >= 2:
            best_rank = None
            for pos in range(len(ids) - 1):
                rank = self.ranks.get((ids[pos], ids[pos + 1]))
                if rank is not None and (best_rank is None or rank < best_rank):
                    best_rank = rank
            if best_rank is None:
                break
            pair = self.merges[best_rank]
            merged_id = 256 + best_rank
            out = []
            i = 0
            while i < len(ids):
                if i < len(ids) - 1 and ids[i] == pair[0] and ids[i + 1] == pair[1]:
                    out.append(merged_id)
                    i += 2
                else:
                    out.append(ids[i])
                    i += 1
            ids = out
        return ids

    def encode(self, text: str) -> List[int]:
        return self.encode_ordinary(text)

    def decode(self, ids: Sequence[int]) -> str:
        specials = set(self.special_tokens.values())
        data = b"".join(self._decode_table[i] for i in ids if i not in specials)
        return data.decode("utf-8", errors="replace")

    @classmethod
    def train(cls, texts: Iterable[str], vocab_size: int) -> "BPETokenizer":
        """Merges until ``vocab_size`` (>= 257) ids: each round merges the
        most frequent adjacent pair (ties: the smallest ids) over the
        corpus's space-split words, each with its leading space; stops
        early when no pair occurs twice."""
        n_merges = max(0, vocab_size - 257)
        words: Counter = Counter()
        for text in texts:
            for word in text.split(" "):
                words[tuple((" " + word).encode("utf-8"))] += 1
        merges: List[Tuple[int, int]] = []
        for merge_index in range(n_merges):
            pairs: Counter = Counter()
            for word, freq in words.items():
                for a, b in zip(word, word[1:]):
                    pairs[(a, b)] += freq
            if not pairs:
                break
            best = max(pairs, key=lambda p: (pairs[p], -p[0], -p[1]))
            if pairs[best] < 2:
                break
            new_id = 256 + merge_index
            merges.append(best)
            new_words: Counter = Counter()
            for word, freq in words.items():
                out = []
                i = 0
                while i < len(word):
                    if i < len(word) - 1 and (word[i], word[i + 1]) == best:
                        out.append(new_id)
                        i += 2
                    else:
                        out.append(word[i])
                        i += 1
                new_words[tuple(out)] += freq
            words = new_words
        return cls(merges)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"merges": self.merges, "special_tokens": self.special_tokens}, f)

    @classmethod
    def load(cls, path: str) -> "BPETokenizer":
        with open(path) as f:
            raw = json.load(f)
        return cls([tuple(m) for m in raw["merges"]], raw.get("special_tokens"))
