"""Evaluate a checkpoint on a token file: loss, perplexity, bits per token.

The PyTorch port's counterpart of the JAX package's ``scripts/evaluate.py``,
with its flags and its one JSON line. The batches are the trainer's eval
batches (``data.sample_seed + 104729`` unless ``--seed`` is given) and the
loss is the trainer's eval loop (``training/train_step.py::
build_eval_loop``), so the number equals the training log's ``val_loss``
on the same device. Runs on the GPU; ``--device cpu`` runs the kernels'
plain PyTorch versions.

Examples::

    python -m pretraining_llm_tpu_torch.evaluate --model_path build/ck --data data/parity/val.bin
    python -m pretraining_llm_tpu_torch.evaluate --model_path build/ck/step-20 \\
        --data data/parity/val.bin --iters 4 --batch 4 --device cpu
"""

from __future__ import annotations

import argparse
import json
import math
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from pretraining_llm_tpu_torch.config import Config
from pretraining_llm_tpu_torch.data import loader
from pretraining_llm_tpu_torch.generation.generate import load_model_for_inference
from pretraining_llm_tpu_torch.training import train_step as ts
from pretraining_llm_tpu_torch.training.trainer import EVAL_SEED_OFFSET


def eval_loss(params: Dict[str, Any], cfg: Config, data: str, *, iters: int = 50, batch: int = 0,
              seed: int = -1) -> float:
    """Mean eval loss of ``params`` over ``iters`` batches of ``data`` (the
    trainer's batches and eval loop; ``batch`` 0 = the config's train
    batch, ``seed`` -1 = the trainer's eval seed)."""
    batch = batch or cfg.train.batch_size
    seed = seed if seed >= 0 else cfg.data.sample_seed + EVAL_SEED_OFFSET
    it = loader.get_batch_iterator(data, batch, cfg.model.context_length, seed=seed)
    xs, ys = zip(*(next(it) for _ in range(iters)))
    dev = params["tok_embed"]["embedding"].device
    batches = (torch.from_numpy(np.stack(xs)).to(dev), torch.from_numpy(np.stack(ys)).to(dev))
    return float(ts.build_eval_loop(cfg)({"params": params}, batches))


def evaluate(model_path: str, data: str, *, iters: int = 50, batch: int = 0, ema: bool = False,
             seed: int = -1, device: Any = None) -> Dict[str, Any]:
    """The JSON record ``main`` prints, for a checkpoint of either package."""
    params, cfg = load_model_for_inference(model_path, use_ema=ema, device=device)
    batch = batch or cfg.train.batch_size
    loss = eval_loss(params, cfg, data, iters=iters, batch=batch, seed=seed)
    return {
        "val_loss": round(loss, 6),
        "val_ppl": round(math.exp(loss), 3) if loss < 700 else float("inf"),
        "val_bits_per_token": round(loss / math.log(2), 4),
        "iters": iters,
        "batch": batch,
        "context_length": cfg.model.context_length,
        "tokens_evaluated": iters * batch * cfg.model.context_length,
        "checkpoint": os.path.abspath(model_path),
    }


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model_path", required=True, help="checkpoint dir (or step-N dir)")
    ap.add_argument("--data", required=True, help="uint16 token .bin")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--batch", type=int, default=0, help="0 = checkpoint's train batch")
    ap.add_argument("--ema", action="store_true", help="evaluate the EMA shadow params")
    ap.add_argument("--seed", type=int, default=-1,
                    help="-1 = the trainer's own eval seed (data.sample_seed + 104729)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="'cpu' runs the kernels' plain PyTorch versions")
    args = ap.parse_args(argv)
    record = evaluate(args.model_path, args.data, iters=args.iters, batch=args.batch, ema=args.ema,
                      seed=args.seed, device=args.device)
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
