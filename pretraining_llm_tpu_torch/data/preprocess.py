"""Offline tokenize-and-pack: documents -> flat token memmaps.

Counterpart of ``pretraining_llm_tpu/data/preprocess.py``: documents from
.txt files (one document each) or .jsonl files (a ``text`` field per
line), a seeded train/val split, each document encoded with its
<|endoftext|> appended, and one flat ``train.bin`` / ``val.bin`` each, in
uint16 (uint32 past 65536 ids). Given the same files, tokenizer and seed,
the files are byte for byte the JAX package's. Encoding runs in worker
processes (``spawn``) when there are more than 8 documents.
"""

from __future__ import annotations

import json
import multiprocessing
import os
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from pretraining_llm_tpu_torch.data.tokenizer import get_tokenizer

_WRITE_CHUNK_DOCS = 1024  # documents per write to the memmap


def _encode_doc(args: Tuple[str, str]) -> List[int]:
    text, tokenizer_name = args
    tok = get_tokenizer(tokenizer_name)
    ids = tok.encode_ordinary(text)
    ids.append(tok.eot_token)
    return ids


def iter_text_files(paths: Sequence[str]) -> Iterator[str]:
    """Documents from .txt (one per file) or .jsonl (a 'text' field per
    non-empty line)."""
    for path in paths:
        if path.endswith(".jsonl"):
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        yield json.loads(line)["text"]
        else:
            with open(path) as f:
                yield f.read()


def split_documents(docs: Iterable[str], val_fraction: float, seed: int) -> Tuple[List[str], List[str]]:
    """Deterministic train/val split: the first max(1, n * val_fraction)
    documents of a seeded permutation go to val (none of a one-document
    corpus)."""
    docs = list(docs)
    order = np.random.default_rng(seed).permutation(len(docs))
    n_val = max(1, int(len(docs) * val_fraction)) if len(docs) > 1 else 0
    val_idx = set(order[:n_val].tolist())
    train = [d for i, d in enumerate(docs) if i not in val_idx]
    val = [d for i, d in enumerate(docs) if i in val_idx]
    return train, val


def token_dtype(n_vocab: int) -> np.dtype:
    return np.dtype(np.uint16) if n_vocab <= np.iinfo(np.uint16).max + 1 else np.dtype(np.uint32)


def write_token_file(
    docs: Sequence[str], out_path: str, tokenizer_name: str, num_proc: Optional[int] = None,
) -> int:
    """Encode ``docs`` and write one flat token array; returns its length."""
    tok = get_tokenizer(tokenizer_name)
    dtype = token_dtype(tok.n_vocab)
    num_proc = num_proc or min(multiprocessing.cpu_count(), 8)
    args = [(d, tokenizer_name) for d in docs]
    if num_proc > 1 and len(docs) > 8:
        with multiprocessing.get_context("spawn").Pool(num_proc) as pool:
            encoded = pool.map(_encode_doc, args, chunksize=32)
    else:
        encoded = [_encode_doc(a) for a in args]

    total = sum(len(e) for e in encoded)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    mm = np.memmap(out_path, dtype=dtype, mode="w+", shape=(total,))
    pos = 0
    for start in range(0, len(encoded), _WRITE_CHUNK_DOCS):
        chunk = np.concatenate([np.asarray(e, dtype) for e in encoded[start:start + _WRITE_CHUNK_DOCS]])
        mm[pos:pos + len(chunk)] = chunk
        pos += len(chunk)
    mm.flush()
    del mm
    return total


def preprocess(
    *,
    input_files: Optional[Sequence[str]] = None,
    dataset_name: Optional[str] = None,
    out_dir: str = "data",
    tokenizer_name: str = "gpt2",
    val_fraction: float = 0.0005,
    seed: int = 42,
    num_proc: Optional[int] = None,
    max_docs: Optional[int] = None,
) -> Tuple[str, str]:
    """Documents -> (train_path, val_path) under ``out_dir``. A one-document
    corpus gives val the tail of the document (max(val_fraction, 1%) of
    its characters). ``dataset_name`` (a Hugging Face dataset) needs the
    ``datasets`` package and its cache or the network."""
    if input_files:
        docs = list(iter_text_files(input_files))
    elif dataset_name:
        try:
            from datasets import load_dataset
        except ImportError as e:
            raise RuntimeError(
                f"dataset_name={dataset_name!r} needs the 'datasets' package and its cache "
                "or the network; pass local .txt/.jsonl input_files instead"
            ) from e
        ds = load_dataset(dataset_name, split="train", trust_remote_code=True)
        docs = [row["text"] for row in ds]
    else:
        raise ValueError("provide input_files or dataset_name")
    if max_docs:
        docs = docs[:max_docs]
    if not docs:
        raise ValueError("no documents found")

    train_docs, val_docs = split_documents(docs, val_fraction, seed)
    if not val_docs:
        text = train_docs[-1]
        cut = max(1, int(len(text) * (1 - max(val_fraction, 0.01))))
        train_docs[-1], val_docs = text[:cut], [text[cut:]]

    train_path = os.path.join(out_dir, "train.bin")
    val_path = os.path.join(out_dir, "val.bin")
    n_train = write_token_file(train_docs, train_path, tokenizer_name, num_proc)
    n_val = write_token_file(val_docs, val_path, tokenizer_name, num_proc)
    print(f"wrote {n_train} train tokens -> {train_path}, {n_val} val tokens -> {val_path}")
    return train_path, val_path
