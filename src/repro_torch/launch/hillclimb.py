"""Hillclimb driver: re-plan a dry-run cell under a named variant (rule
overrides + parallel config) and record the roofline delta.

    python -m repro_torch.launch.hillclimb --cell falcon_train --variant A1_bf16_residual
    python -m repro_torch.launch.hillclimb --all

The port of ``repro/launch/hillclimb.py``, with the reference's cells and
variants (explicit, named hypotheses), each planned by
``dryrun.run_cell`` (fake tensors over a fake group; run it in its own
process).  A "_regroup" patch is ignored, as in the reference.  Results
land in ``build/perf/<cell>__<variant>.json``.

The EP-2D variants hold each rank's experts over the data axis too and
exchange the dispatch buffer by an all-to-all (``models/moe.py``);
``P1_seq_over_model`` runs the residual sequence-parallel over the
``model`` axis (``models/transformer.py``).
"""
import argparse
import json
from pathlib import Path

from repro_torch.configs.base import ParallelConfig
from repro_torch.launch.dryrun import run_cell
from repro_torch.parallel.sharding import AxisRules

PERF_DIR = Path(__file__).resolve().parents[3] / "build" / "perf"

EP2D = (("expert", ("model", "data")),
        ("act_expert2", ("model", "data")),
        ("expert_embed", None),
        ("moe_group2", None))
SERVE_NO_FSDP = (("embed", None),)
# multi-pod EP-2D: experts over (model,data), dispatch groups over pods
EP2D_POD = (("expert", ("model", "data")),
            ("act_expert2", ("model", "data")),
            ("expert_embed", None),
            ("moe_group2", "pod"))

# cell -> (arch, shape, [(variant, rules-overrides, pcfg-kwargs, cfg-patch)])
CELLS = {
    "falcon_train": ("falcon_mamba_7b", "train_4k", [
        ("A1_bf16_residual", (), {}, {}),
        ("A2_bf16+micro8", (), {"microbatches": 8}, {}),
        ("A3_bf16+micro8+optbf16", (), {"microbatches": 8,
                                        "opt_state_dtype": "bfloat16"}, {}),
        ("A4_bf16+micro16", (), {"microbatches": 16}, {}),
        ("A5_scanbf16", (), {}, {"ssm.scan_dtype": "bfloat16"}),
        ("A6_scanbf16+micro8", (), {"microbatches": 8},
         {"ssm.scan_dtype": "bfloat16"}),
        ("A8_best@2pod", (), {"microbatches": 16}, {}),
        ("A9_micro8@2pod", (), {"microbatches": 8}, {}),
    ]),
    "dsv3_decode": ("deepseek_v3_671b", "decode_32k", [
        ("B1_no_fsdp", SERVE_NO_FSDP, {}, {}),
        ("B2_ep2d", EP2D, {}, {}),
        ("B3_no_fsdp+ep2d", SERVE_NO_FSDP + EP2D, {}, {}),
        ("B4_ep2d+grouped", EP2D, {}, {"_regroup": True}),
        ("B5_grouped_only", (), {}, {"_regroup": True}),
    ]),
    "dsv3_train": ("deepseek_v3_671b", "train_4k", [
        ("C1_ep2d", EP2D, {}, {}),
        ("C2_ep2d+micro8", EP2D, {"microbatches": 8}, {}),
        ("C3_ep2d+micro8+optbf16", EP2D, {"microbatches": 8,
                                          "opt_state_dtype": "bfloat16"}, {}),
        ("C4_micro8", (), {"microbatches": 8}, {}),
        ("C5_fixes", (), {}, {}),
        ("C6_fixes+ep2d", EP2D, {}, {}),
        ("C7_fixes+ep2d+micro8+optbf16", EP2D,
         {"microbatches": 8, "opt_state_dtype": "bfloat16"}, {}),
        ("C8_best@2pod", EP2D,
         {"microbatches": 8, "opt_state_dtype": "bfloat16"}, {}),
        ("C9_ep2dpod@2pod", EP2D_POD,
         {"microbatches": 8, "opt_state_dtype": "bfloat16"}, {}),
        ("C10_default+micro8@2pod", (),
         {"microbatches": 8, "opt_state_dtype": "bfloat16"}, {}),
    ]),
    "yi_prefill": ("yi_9b", "prefill_32k", [
        ("P1_seq_over_model", (("seq", "model"),), {}, {}),
    ]),
    "dsv3_decode2": ("deepseek_v3_671b", "decode_32k", [
        ("B6_fixes", (), {}, {}),
        ("B7_fixes+ep2d", EP2D, {}, {}),
        ("B8_carry_cache", (), {}, {}),
        ("B9_carry_cache+ep2d", EP2D, {}, {}),
        ("B10_best@2pod", EP2D, {}, {}),
    ]),
}


def run_variant(cell: str, variant: str):
    arch, shape, variants = CELLS[cell]
    spec = dict((v, (r, p, c)) for v, r, p, c in variants)
    rules_over, pcfg_kw, cfg_patch = spec[variant]
    cfg_patch = {k: v for k, v in cfg_patch.items() if not k.startswith("_")}
    rules = AxisRules()
    for name, axes in rules_over:
        rules = rules.replacing(name, axes)
    pcfg = ParallelConfig(**pcfg_kw)
    rec = run_cell(arch, shape, multi_pod=variant.endswith("@2pod"),
                   out_dir=PERF_DIR, rules=rules, pcfg=pcfg, tag=variant,
                   cfg_patch=cfg_patch)
    PERF_DIR.mkdir(parents=True, exist_ok=True)
    path = PERF_DIR / f"{cell}__{variant}.json"
    path.write_text(json.dumps(rec, indent=2, default=str))
    if rec.get("status") == "ok":
        r = rec["roofline"]
        print(f"[{cell}/{variant}] t_c={r['t_compute']:.3e} "
              f"t_m={r['t_memory']:.3e} t_coll={r['t_collective']:.3e} "
              f"bneck={r['bottleneck']} peak={r['peak_mem_bytes']/2**30:.1f}GiB "
              f"plan={rec['plan_s']:.1f}s", flush=True)
    else:
        print(f"[{cell}/{variant}] {rec.get('status')}: "
              f"{rec.get('reason', rec.get('error', ''))[:200]}", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", choices=list(CELLS), default=None)
    ap.add_argument("--variant", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)
    targets = []
    for cell, (_, _, variants) in CELLS.items():
        if args.cell and cell != args.cell:
            continue
        for v, *_ in variants:
            if args.variant and v != args.variant:
                continue
            targets.append((cell, v))
    for cell, v in targets:
        path = PERF_DIR / f"{cell}__{v}.json"
        if path.exists() and not args.force:
            print(f"[cached] {cell}/{v}")
            continue
        run_variant(cell, v)


if __name__ == "__main__":
    main()
