#!/usr/bin/env bash
# Sequence parallelism and int8 AdamW state on four cards of one host:
# the NCCL parity tests (SP over (1, 4), int8 state over (2, 2), each
# against the unsharded step), then tools/sp_cells.py's cells:
# Llama-3.2-1B training at its published config, 8 x 1024, over (1, 4)
# and (2, 2) under the default rules and under SP; the same cell with
# int8 against float32 AdamW state over (4, 1) and (2, 2); Yi-9B's
# 32768-token prefill at its published config over (1, 4) under both
# rule sets, the flash kernel at a rank's shape and the dry-run's plan of
# the cell.  Each command's output goes to chiprun_out/sp4/ (the cells'
# JSON lines to chiprun_out/sp4/cells.jsonl); run from the root of the
# repo:
#
#   bash tools/sp_four_cards.sh   # one host with four H100s
set -u
out=chiprun_out/sp4
source tools/four_cards_common.sh
run gpu_tests python -m pytest -q --noconftest -m gpu -p no:cacheprovider \
    tests/test_torch_sp.py tests/test_torch_int8_mesh.py -s
port=29620
for cell in train int8 prefill; do
    port=$((port + 1))
    run "cell_$cell" torchrun --nproc-per-node 4 --master-port $port \
        tools/sp_cells.py --cell "$cell" --out "$out/cells.jsonl"
done
free -b | tee -a "$out/summary.txt"
exit $status
