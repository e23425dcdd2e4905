#!/usr/bin/env bash
# The pipe axis on four cards: gpt2-1p3b-fsdp at full depth (24 layers,
# d 2048), 3 AdamW steps of the preset's 64 x 1024 synthetic tokens in 2
# train microbatches, each split into 8 pipeline microbatches; pipe 4 at
# V 1 and V 2, pipe 2 x fsdp 2, and one card at pipe 1 (the first loss's
# reference). Each run goes through the port's train CLI under torchrun
# (NCCL, one card a rank) in chip_smoke.py's --x1-child mode, which writes
# each rank's peak memory, wall seconds, hops and kernel launches;
# the step logs are train.metrics_path's JSON lines; both land in the
# directory given as the first argument (default build/x4p/out). Run from
# the repository root on a four-card machine:
#   bash pretraining_llm_tpu_torch/utils/x4_pipe.sh [OUT_DIR]
set -euo pipefail
OUT=${1:-build/x4p/out}
A="--data synthetic --no-resume --override train.train_steps=3 train.log_interval=1 train.eval_interval=0 train.checkpoint_interval=0 train.save_final=False mesh.fsdp=1"
P="model.pipeline_microbatches=8"
run() { n=$1; shift; python -m torch.distributed.run --nnodes 1 --nproc_per_node "$n" --master_addr 127.0.0.1 --master_port $((29400 + n)) chip_smoke.py --x1-child "build/x4p/w$n.json" "$@"; }
mkdir -p build/x4p "$OUT"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
run 4 -- --preset gpt2-1p3b-fsdp $A mesh.pipe=4 model.pipeline_stages=4 $P train.metrics_path=$OUT/pipe4_v1.jsonl \
      -- --preset gpt2-1p3b-fsdp $A mesh.pipe=4 model.pipeline_stages=4 model.pipeline_interleave=2 $P train.metrics_path=$OUT/pipe4_v2.jsonl \
      -- --preset gpt2-1p3b-fsdp $A mesh.fsdp=2 mesh.pipe=2 model.pipeline_stages=2 $P train.metrics_path=$OUT/pipe2_fsdp2.jsonl
run 1 -- --preset gpt2-1p3b-fsdp $A train.metrics_path=$OUT/w1.jsonl
cp build/x4p/w4.json.[0-3] build/x4p/w1.json "$OUT/"
python - <<'PY'
import torch
for i in range(3):
    print("first loss, four-card run", i, torch.load(f"build/x4p/w4.json.first{i}.pt")["loss"])
print("first loss, one card", torch.load("build/x4p/w1.json.first0.pt")["loss"])
PY
