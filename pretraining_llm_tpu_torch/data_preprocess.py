"""Tokenize a corpus into train/val token memmaps: the PyTorch port's
counterpart of the JAX package's ``scripts/data_preprocess.py``, with its
flags. Tokenization runs on the host; ``--device`` only follows the port's
rule that entry points run on the GPU unless ``--device cpu`` is given.

Examples::

    python -m pretraining_llm_tpu_torch.data_preprocess --input corpus.txt \\
        --out_dir build/data --tokenizer byte --device cpu
    python -m pretraining_llm_tpu_torch.data_preprocess --input docs.jsonl \\
        --out_dir build/data --tokenizer build/bpe.json
"""

from __future__ import annotations

import argparse
from typing import List, Optional, Tuple

from pretraining_llm_tpu_torch.data.preprocess import preprocess
from pretraining_llm_tpu_torch.utils.device import resolve_device


def main(argv: Optional[List[str]] = None) -> Tuple[str, str]:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--input", nargs="*", default=None, help=".txt or .jsonl files")
    parser.add_argument("--dataset", default=None, help="HF dataset name (needs 'datasets' and its cache or network)")
    parser.add_argument("--out_dir", default="data")
    parser.add_argument("--tokenizer", default="gpt2", help="gpt2 | byte | path/to/bpe.json")
    parser.add_argument("--val_fraction", type=float, default=0.0005)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--num_proc", type=int, default=None)
    parser.add_argument("--max_docs", type=int, default=None)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="the port's device rule; tokenization itself runs on the host")
    args = parser.parse_args(argv)
    resolve_device(args.device)
    return preprocess(
        input_files=args.input, dataset_name=args.dataset, out_dir=args.out_dir,
        tokenizer_name=args.tokenizer, val_fraction=args.val_fraction, seed=args.seed,
        num_proc=args.num_proc, max_docs=args.max_docs,
    )


if __name__ == "__main__":
    main()
