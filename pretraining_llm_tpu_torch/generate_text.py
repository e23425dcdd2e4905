"""Sampling entry point of the PyTorch port.

The flags of the JAX package's ``scripts/generate_text.py``: a checkpoint
of either package (a run directory or a ``step-N`` directory), one prompt
(``--input_text``) or a file of prompts, one per line, decoded as one
ragged batch (``--input_file``), and the sampling knobs. With
``--draft_model_path`` one prompt is decoded speculatively: the draft
checkpoint proposes ``--spec_k`` tokens a round and the target verifies
them (greedy output equals the target's alone). Runs on the GPU;
``--device cpu`` runs the kernels' plain PyTorch versions on the CPU.

Examples::

    python -m pretraining_llm_tpu_torch.generate_text --model_path build/ck \\
        --input_text "Once upon a time" --max_new_tokens 100 --temperature 0.8 --top_k 50
    python -m pretraining_llm_tpu_torch.generate_text --model_path build/ck \\
        --input_file prompts.txt --temperature 0 --device cpu
    python -m pretraining_llm_tpu_torch.generate_text --model_path build/ck \\
        --draft_model_path build/draft --spec_k 4 --input_text "Hello" --temperature 0
"""

from __future__ import annotations

import argparse
from typing import List, Optional

from pretraining_llm_tpu_torch.generation import generate as gen


def main(argv: Optional[List[str]] = None) -> List[str]:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--model_path", required=True, help="checkpoint dir (or a step-N dir)")
    group = parser.add_mutually_exclusive_group(required=True)
    group.add_argument("--input_text")
    group.add_argument("--input_file", help="one prompt per line, decoded as one ragged batch")
    parser.add_argument("--max_new_tokens", type=int, default=100)
    parser.add_argument("--temperature", type=float, default=1.0, help="0 = greedy")
    parser.add_argument("--top_k", type=int, default=None)
    parser.add_argument("--top_p", type=float, default=None)
    parser.add_argument("--min_p", type=float, default=None, help="keep tokens with prob >= min_p * max prob")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--tokenizer", default=None, help="override the tokenizer name stored in the checkpoint")
    parser.add_argument("--stop_token", type=int, default=None,
                        help="token id that ends a row's generation (output truncates there)")
    parser.add_argument("--draft_model_path", default=None,
                        help="draft checkpoint for speculative decoding of --input_text")
    parser.add_argument("--spec_k", type=int, default=4, help="draft proposals per speculative round")
    parser.add_argument("--ema", action="store_true", help="decode from the EMA shadow params")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="'cpu' runs the kernels' plain PyTorch versions")
    args = parser.parse_args(argv)

    if args.draft_model_path:
        if args.input_file:
            parser.error("--draft_model_path is the batch-1 latency path; use --input_text")
        if args.stop_token is not None or args.top_k or args.top_p or args.min_p or args.ema:
            parser.error("--draft_model_path supports --temperature only "
                         "(no stop_token/top_k/top_p/min_p/ema yet)")
        text = gen.generate_text_speculative(
            args.model_path, args.draft_model_path, args.input_text, args.max_new_tokens,
            k=args.spec_k, temperature=args.temperature, seed=args.seed, tokenizer=args.tokenizer,
            device=args.device,
        )
        print(text)
        return [text]
    if args.input_file:
        with open(args.input_file) as f:
            prompts = [line.rstrip("\r\n") for line in f if line.strip()]
    else:
        prompts = [args.input_text]
    outs = gen.generate_text_batch(
        args.model_path, prompts, args.max_new_tokens, temperature=args.temperature, top_k=args.top_k,
        top_p=args.top_p, min_p=args.min_p, seed=args.seed, tokenizer=args.tokenizer,
        stop_token=args.stop_token, ema=args.ema, device=args.device,
    )
    for text in outs:
        print(text)
        if args.input_file:
            print("---")
    return outs


if __name__ == "__main__":
    main()
