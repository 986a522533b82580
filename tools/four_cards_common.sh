# The preamble of tools/*_four_cards.sh, sourced after the script sets
# `out` (its output directory) and, where it wants one, `run_timeout`
# (seconds a command may take; 0, the default, for no limit).  Makes
# $out, puts src on PYTHONPATH, writes the cards' name and power limit,
# torch's versions and the host's memory to $out/card.txt, and defines
# `run` and `status` (the last non-zero exit code of a run).
mkdir -p "$out" build
export PYTHONPATH=src
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader \
    | tee "$out/card.txt"
python -c 'import sys, torch; print(sys.version, torch.__version__,
           torch.version.cuda, torch.cuda.device_count())' | tee -a "$out/card.txt"
free -b | tee -a "$out/card.txt"
status=0
run_timeout=${run_timeout:-0}
run() {  # name, command...: the command's output to $out/name.txt; the
         # host's used memory sampled every 2 s into $out/mem_name.txt
         # (bytes); its exit code, seconds, peak host memory and rank 0's
         # `[serve]` lines appended to $out/summary.txt
    local name=$1
    shift
    local t0=$SECONDS
    (while true; do free -b | awk '/^Mem:/ {print $3}'; sleep 2; done) \
        > "$out/mem_$name.txt" &
    local sampler=$!
    timeout -k 10 "$run_timeout" "$@" > "$out/$name.txt" 2>&1
    local rc=$?
    kill $sampler
    wait $sampler 2>/dev/null
    local peak
    peak=$(sort -n "$out/mem_$name.txt" | tail -n 1)
    echo "$name: exit $rc in $((SECONDS - t0)) s, host memory used at" \
        "most $peak bytes" | tee -a "$out/summary.txt"
    grep -h '^\[serve\]' "$out/$name.txt" | tee -a "$out/summary.txt"
    tail -n 3 "$out/$name.txt"
    [ $rc -eq 0 ] || status=$rc
}
