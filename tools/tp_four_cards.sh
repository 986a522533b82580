#!/usr/bin/env bash
# Tensor parallelism on four cards of one host: the NCCL parity tests,
# Llama-3.2-1B training at its published config over (4, 1), (2, 2) and
# (1, 4) meshes (rank 0's median step, peak memory and a profiled step's
# split by collective), and DeepSeek-67B served at its published widths
# over a (1, 4) pilot mesh.  Each command's output goes to
# chiprun_out/tp4/; run from the root of the repo:
#
#   bash tools/tp_four_cards.sh   # one host with four H100s
set -u
out=chiprun_out/tp4
source tools/four_cards_common.sh
run gpu_tests python -m pytest -q --noconftest -m gpu -p no:cacheprovider \
    tests/test_torch_parallel.py tests/test_torch_tp.py -s
port=29600
for mp in 1 2 4; do
    port=$((port + 1))
    run "train_mp$mp" torchrun --nproc-per-node 4 --master-port $port \
        -m repro_torch.launch.train --preset full --steps 10 --batch 8 \
        --seq 1024 --log-every 1 --ckpt-every 100 --model-parallel $mp \
        --trace-step 6 --ckpt-dir "build/tp4_train_mp$mp"
    rm -rf "build/tp4_train_mp$mp"
done
run serve_deepseek_67b torchrun --nproc-per-node 4 --master-port 29611 \
    -m repro_torch.launch.serve --arch deepseek_67b --preset full \
    --mesh 1x4 --requests 16 --batch 8 --gen 64 \
    --prompt-len 256 --prompt-len-max 1024 --max-len 2048 --memory-gb 8
free -b | tee -a "$out/summary.txt"
exit $status
