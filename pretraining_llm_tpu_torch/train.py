"""Training entry point of the PyTorch port.

The flag names of the JAX package's ``scripts/train.py`` for what is
ported: a preset (every single-device preset of the JAX package: gpt2-124m,
gpt2-350m-dp, gpt2-1p3b-fsdp, llama-1b, llama3-1b-gqa, reference-3b,
tiny), dotted overrides of any model, data or train field, file, mixture
or synthetic data, ``--no-resume`` and ``--steps``. ``--obs-dir`` and
``--compile-only`` are not ported. Runs on the GPU; ``--device cpu`` runs
the plain PyTorch versions of the kernels on the CPU.

Examples::

    python -m pretraining_llm_tpu_torch.train --preset tiny --data synthetic \\
        --override train.train_steps=100
    python -m pretraining_llm_tpu_torch.train --preset reference-3b --data synthetic \\
        --override model.remat=full
    python -m pretraining_llm_tpu_torch.train --preset gpt2-124m --override \\
        train.optimizer=muon train.checkpoint_async=True train.profile_dir=build/prof \\
        data.train_path=data/parity/train.bin:3,data/parity/val.bin:1
    python -m pretraining_llm_tpu_torch.train --preset gpt2-124m \\
        --override data.train_path=data/train.bin data.val_path=data/val.bin
    python -m pretraining_llm_tpu_torch.train --preset gpt2-124m --no-resume \\
        --override model.ce_impl=fused model.doc_mask_token=10 \\
        data.train_path=data/parity/train.bin data.val_path=data/parity/val.bin
"""

from __future__ import annotations

import argparse
import ast
from typing import Any, Dict, List, Optional

from pretraining_llm_tpu_torch.config import get_preset, list_presets
from pretraining_llm_tpu_torch.training.trainer import Trainer


def parse_overrides(pairs: List[str]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for pair in pairs:
        if "=" not in pair:
            raise SystemExit(f"override must be key=value, got {pair!r}")
        key, raw = pair.split("=", 1)
        try:
            out[key] = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            out[key] = raw  # plain string
    return out


def main(argv: Optional[List[str]] = None) -> Dict[str, float]:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--preset", default="gpt2-124m", help=f"one of {list(list_presets())}")
    parser.add_argument("--override", nargs="*", default=[], metavar="SECTION.KEY=VALUE",
                        help="dotted config overrides, e.g. train.lr=1e-4")
    parser.add_argument("--data", default="files", choices=["files", "synthetic"],
                        help="'synthetic' trains on a generated Markov stream (no files needed)")
    parser.add_argument("--no-resume", action="store_true", help="ignore existing checkpoints")
    parser.add_argument("--steps", type=int, default=None, help="override total steps")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="'cpu' runs the kernels' plain PyTorch versions")
    args = parser.parse_args(argv)

    config = get_preset(args.preset).with_overrides(parse_overrides(args.override))
    print(f"preset={config.name} device={args.device} params={config.model.num_params() / 1e6:.1f}M",
          flush=True)
    trainer = Trainer(config, synthetic_data=args.data == "synthetic", resume=not args.no_resume,
                      device=args.device)
    final = trainer.train(steps=args.steps)
    print("final:", final, flush=True)
    return final


if __name__ == "__main__":
    main()
