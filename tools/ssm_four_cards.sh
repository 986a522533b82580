#!/usr/bin/env bash
# The SSM family over a four-card pilot mesh: the NCCL gpu test of
# tests/test_torch_dp_serving.py (reduced Falcon-Mamba's fp32 tokens over
# (1, 4), (4, 1) and (2, 2) against one card), then `launch.serve --mesh`
# under torchrun, greedy, bf16, random weights from the engine's seed:
#
# - Falcon-Mamba-7B, all 64 layers, published widths: 32 requests of
#   1024-2048-token prompts, 64 tokens each, batch 8, max_len 4096; over
#   1x4 (a rank's 2048 of the 8192 inner channels), 4x1 (2 rows a rank),
#   2x2 and on one card;
# - Hymba-1.5B, published config: 32 requests of 512-2048-token prompts,
#   64 tokens each, batch 8, max_len 4096; over 4x1 and on one card (its
#   25/5 heads divide by no `model` size above 1: the data split only).
#
# Each run's rank-0 `[serve]` line gives tok/s, p50/p99, ms a decode
# step, peak device memory a rank, rows and cache bytes a rank and its
# peak host memory; the host's used memory is sampled every 2 s while it
# runs (mem_<name>.txt, bytes).  Each command's output goes to
# chiprun_out/ssm4/; run from the root of the repo:
#
#   bash tools/ssm_four_cards.sh             # one host with four H100s
set -u
out=chiprun_out/ssm4
run_timeout=900
source tools/four_cards_common.sh
run gpu_tests python -m pytest -q --noconftest -m gpu -p no:cacheprovider \
    tests/test_torch_dp_serving.py -s
falcon=(--arch falcon_mamba_7b --preset full --requests 32 --gen 64
        --batch 8 --prompt-len 1024 --prompt-len-max 2048 --max-len 4096
        --memory-gb 8)
hymba=(--arch hymba_1_5b --preset full --requests 32 --gen 64 --batch 8
       --prompt-len 512 --prompt-len-max 2048 --max-len 4096 --memory-gb 8)
port=29660
for mesh in 1x4 4x1 2x2; do
    port=$((port + 1))
    run "falcon_$mesh" torchrun --nproc-per-node 4 --master-port $port \
        -m repro_torch.launch.serve "${falcon[@]}" --mesh "$mesh"
done
run falcon_one python -m repro_torch.launch.serve "${falcon[@]}"
run hymba_4x1 torchrun --nproc-per-node 4 --master-port $((port + 1)) \
    -m repro_torch.launch.serve "${hymba[@]}" --mesh 4x1
run hymba_one python -m repro_torch.launch.serve "${hymba[@]}"
free -b | tee -a "$out/summary.txt"
exit $status
