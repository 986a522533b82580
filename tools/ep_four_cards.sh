#!/usr/bin/env bash
# Expert parallelism and MLA's heads on four cards of one host: the NCCL
# gpu tests of tests/test_torch_ep.py, Mixtral-8x22B served at its
# published widths and all 56 layers over a (1, 4) pilot mesh (at batch
# 4: a batch-8 prefill wave of a 4608-token prompt does not fit beside
# its 70.93 GB of weights a rank, tools/rank_memory.py), DeepSeek-V3 at
# its published widths cut to 15 layers (3 dense + 12 MoE, 71.8 GB a
# rank) over (1, 4), Mixtral at its published widths cut to 4 layers
# trained over (2, 2) under the default rules and under EP-2D
# (tools/ep_train.py, a traced step each), and the EF-int8 pod mean over
# a (2, 1, 2) mesh.
# Each command's output goes to chiprun_out/ep4/, with the host's used
# memory sampled every 2 s while it runs (mem_<name>.txt, bytes); run from
# the root of the repo:
#
#   bash tools/ep_four_cards.sh   # one host with four H100s
set -u
out=chiprun_out/ep4
source tools/four_cards_common.sh
run gpu_tests python -m pytest -q --noconftest -m gpu -p no:cacheprovider \
    tests/test_torch_ep.py -s
run serve_mixtral torchrun --nproc-per-node 4 --master-port 29621 \
    -m repro_torch.launch.serve --arch mixtral_8x22b --preset full \
    --mesh 1x4 --requests 16 --batch 4 --gen 64 \
    --prompt-len 1024 --prompt-len-max 4608 --max-len 8192 --memory-gb 2
run serve_deepseek torchrun --nproc-per-node 4 --master-port 29622 \
    -m repro_torch.launch.serve --arch deepseek_v3_671b --preset full \
    --layers 15 --mesh 1x4 --requests 16 --batch 8 --gen 64 \
    --prompt-len 256 --prompt-len-max 1024 --max-len 2048 --memory-gb 2
run train_ep torchrun --nproc-per-node 4 --master-port 29623 \
    tools/ep_train.py --layers 4 --steps 10 --seq 1024 --trace-step 6 \
    --out "$out/train_ep.jsonl"
free -b | tee -a "$out/summary.txt"
exit $status
