"""Autotuner: sweep sharding-rule / parallel-config variants for a cell and
pick the best by roofline step time (subject to the HBM fit constraint).

    python -m repro_torch.launch.autotune --arch yi_9b --shape train_4k
    python -m repro_torch.launch.autotune --arch deepseek_v3_671b --shape decode_32k

The port of ``repro/launch/autotune.py``: the candidate set encodes the
reference's levers (EP layouts, microbatching, optimizer dtype, sequence
parallelism), and the tuner plans each with ``dryrun.run_cell`` (fake
tensors over a fake group; run it in its own process), never touching a
card.  Winners are written to ``build/autotune/<arch>__<shape>__<mesh>.json``.

The models run tensor-parallel over the ``model`` axis and
expert-parallel where the rules put ``expert`` on it; an EP-2D variant
also holds each rank's experts over the data axis and exchanges the
dispatch buffer by an all-to-all (``models/moe.py``), and the
``seq_parallel`` variant (``SP``) runs the residual sequence-parallel
over the ``model`` axis (``models/transformer.py``).
"""
import argparse
import json
from pathlib import Path

from repro_torch.configs import get_config
from repro_torch.configs.base import ParallelConfig, SHAPES
from repro_torch.launch.dryrun import mesh_name, run_cell
from repro_torch.parallel.sharding import AxisRules

OUT_DIR = Path(__file__).resolve().parents[3] / "build" / "autotune"

EP2D = (("expert", ("model", "data")), ("act_expert2", ("model", "data")),
        ("expert_embed", None), ("moe_group2", None))
EP2D_POD = EP2D[:-1] + (("moe_group2", "pod"),)
SP = (("seq", "model"),)


def candidates(cfg, shape, multi_pod: bool):
    """(name, rule-overrides, pcfg) candidates appropriate for the cell."""
    cands = [("default", (), ParallelConfig())]
    if shape.kind == "train":
        for mu in (4, 8):
            # microbatches must keep per-shard batch >= 1
            if shape.global_batch % mu == 0:
                cands.append((f"micro{mu}", (),
                              ParallelConfig(microbatches=mu)))
        cands.append(("micro8+optbf16", (),
                      ParallelConfig(microbatches=8,
                                     opt_state_dtype="bfloat16")))
    if shape.kind == "prefill":
        cands.append(("seq_parallel", SP, ParallelConfig()))
    if cfg.is_moe and cfg.moe.num_experts >= 64:
        ep = EP2D_POD if multi_pod else EP2D
        cands.append(("ep2d", ep, ParallelConfig()))
        if shape.kind == "train":
            cands.append(("ep2d+micro8+optbf16", ep,
                          ParallelConfig(microbatches=8,
                                         opt_state_dtype="bfloat16")))
    return cands


def step_time(rec) -> float:
    r = rec["roofline"]
    return max(r["t_compute"], r["t_memory"], r["t_collective"])


def tune(arch: str, shape_name: str, multi_pod: bool = False) -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    name = mesh_name(multi_pod)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    results = []
    for cand, rule_over, pcfg in candidates(cfg, shape, multi_pod):
        rules = AxisRules()
        for ln, ax in rule_over:
            rules = rules.replacing(ln, ax)
        rec = run_cell(arch, shape_name, multi_pod, OUT_DIR, rules=rules,
                       pcfg=pcfg, tag=f"autotune:{cand}")
        if rec.get("status") != "ok":
            print(f"  [{cand}] {rec.get('status')}", flush=True)
            continue
        results.append((cand, rec))
        r = rec["roofline"]
        print(f"  [{cand}] step={step_time(rec):.3f}s "
              f"peak={r['peak_mem_bytes']/2**30:.1f}GiB "
              f"bneck={r['bottleneck']}", flush=True)
    if not results:
        raise RuntimeError("no candidate planned")
    # prefer fitting HBM, then minimize step time
    results.sort(key=lambda nr: (not nr[1]["fits_hbm"], step_time(nr[1])))
    best_name, best = results[0]
    summary = {
        "arch": arch, "shape": shape_name, "mesh": name,
        "best": best_name,
        "best_step_s": step_time(best),
        "best_peak_gib": best["roofline"]["peak_mem_bytes"] / 2**30,
        "candidates": {n: {"step_s": step_time(r),
                           "peak_gib": r["roofline"]["peak_mem_bytes"] / 2**30,
                           "fits_hbm": r["fits_hbm"]}
                       for n, r in results},
    }
    out = OUT_DIR / f"{arch}__{shape_name}__{name}.json"
    out.write_text(json.dumps(summary, indent=2))
    print(f"[autotune] best for {arch}/{shape_name}@{name}: {best_name} "
          f"(step {summary['best_step_s']:.3f}s, "
          f"peak {summary['best_peak_gib']:.1f}GiB)")
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multipod", action="store_true")
    args = ap.parse_args(argv)
    tune(args.arch, args.shape, args.multipod)


if __name__ == "__main__":
    main()
