#!/usr/bin/env bash
# The serving batch split over a pilot mesh's data axis, on four cards of
# one host: the NCCL gpu test of tests/test_torch_tp.py (fp32 tokens over
# (1, 4), (4, 1) and (2, 2) against one card), then `launch.serve --mesh`
# under torchrun, greedy, bf16, random weights from the engine's seed:
#
# - Llama-3.2-1B, published config: 64 requests of 96-160-token prompts,
#   64 tokens each, max_len 1024; over 4x1 and 2x2 at batch 32, over 1x4
#   at batch 8 and 32, and on one card at batch 8 and 32;
# - Yi-9B, 48 layers, published widths: 32 requests of 1024-2048-token
#   prompts, 64 tokens each, max_len 8192, batch 8; over 4x1, 2x2, 1x4
#   and on one card.
#
# Each run's rank-0 `[serve]` line gives tok/s, p50/p99, ms a decode
# step, peak device memory a rank, rows and cache bytes a rank and its
# peak host memory; the host's used memory is sampled every 2 s while it
# runs (mem_<name>.txt, bytes).  Each command's output goes to
# chiprun_out/dp4/; run from the root of the repo:
#
#   bash tools/dp_four_cards.sh              # one host with four H100s
set -u
out=chiprun_out/dp4
run_timeout=900
source tools/four_cards_common.sh
llama=(--arch llama3_2_1b --preset full --requests 64 --gen 64
       --prompt-len 96 --prompt-len-max 160 --max-len 1024 --memory-gb 4)
run gpu_tests python -m pytest -q --noconftest -m gpu -p no:cacheprovider \
    tests/test_torch_tp.py -s
port=29640
yi=(--arch yi_9b --preset full --requests 32 --gen 64 --batch 8
    --prompt-len 1024 --prompt-len-max 2048 --max-len 8192 --memory-gb 8)
for cell in 4x1:32 2x2:32 1x4:8 1x4:32; do
    mesh=${cell%%:*} batch=${cell##*:}
    port=$((port + 1))
    run "llama_${mesh}_b$batch" torchrun --nproc-per-node 4 \
        --master-port $port -m repro_torch.launch.serve "${llama[@]}" \
        --mesh "$mesh" --batch "$batch"
done
for batch in 8 32; do
    run "llama_one_b$batch" python -m repro_torch.launch.serve \
        "${llama[@]}" --batch "$batch"
done
for mesh in 4x1 2x2 1x4; do
    port=$((port + 1))
    run "yi_$mesh" torchrun --nproc-per-node 4 --master-port $port \
        -m repro_torch.launch.serve "${yi[@]}" --mesh "$mesh"
done
run yi_one python -m repro_torch.launch.serve "${yi[@]}"
free -b | tee -a "$out/summary.txt"
exit $status
