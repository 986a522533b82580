"""Roofline tables from the dry-run's and the hillclimb's JSON records.

    python -m repro_torch.roofline.report [--dryrun-dir ...] [--perf-dir ...]

The port of ``repro/roofline/report.py``.  "peak GiB" is a rank's
planned peak (``launch.dryrun``: the gathered peak of a serving cell),
"at rest GiB" the shard bytes it holds between steps, and "fits 80G"
compares the peak with one H100's memory (``analysis.HBM_PER_CHIP``).
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]


def _fmt(t: float) -> str:
    if t == 0:
        return "0"
    if t < 1e-3:
        return f"{t*1e6:.0f}us"
    if t < 1:
        return f"{t*1e3:.1f}ms"
    return f"{t:.2f}s"


def load(d: Path):
    recs = []
    for f in sorted(d.glob("*.json")):
        recs.append(json.loads(f.read_text()))
    return recs


def dryrun_table(recs, mesh: str) -> str:
    lines = ["| arch | shape | t_compute | t_memory | t_collective | bottleneck"
             " | roofline frac | useful flops | peak GiB | at rest GiB "
             "| fits 80G |",
             "|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in recs:
        if r.get("mesh") != mesh:
            continue
        if r.get("status") == "skipped":
            lines.append(f"| {r['arch']} | {r['shape']} | — | — | — | "
                         f"skipped | — | — | — | — | — |")
            continue
        if r.get("status") != "ok":
            lines.append(f"| {r['arch']} | {r['shape']} | ERROR ||||||||")
            continue
        ro = r["roofline"]
        lines.append(
            f"| {r['arch']} | {r['shape']} | {_fmt(ro['t_compute'])} | "
            f"{_fmt(ro['t_memory'])} | {_fmt(ro['t_collective'])} | "
            f"{ro['bottleneck']} | {ro['roofline_fraction']:.3f} | "
            f"{ro['useful_flops_ratio']:.2f} | "
            f"{ro['peak_mem_bytes']/2**30:.1f} | "
            f"{ro['arg_bytes']/2**30:.1f} | "
            f"{'yes' if r.get('fits_hbm') else 'no'} |")
    return "\n".join(lines)


def perf_table(recs) -> str:
    lines = ["| cell / variant | t_compute | t_memory | t_collective | "
             "bottleneck | peak GiB |",
             "|---|---|---|---|---|---|"]
    for r in recs:
        tag = r.get("tag", "?")
        if r.get("status") != "ok":
            lines.append(f"| {r['arch']}/{r['shape']} {tag} | "
                         f"{r.get('status', 'ERROR').upper()} |||||")
            continue
        ro = r["roofline"]
        lines.append(
            f"| {r['arch']}/{r['shape']} **{tag}** | {_fmt(ro['t_compute'])} | "
            f"{_fmt(ro['t_memory'])} | {_fmt(ro['t_collective'])} | "
            f"{ro['bottleneck']} | {ro['peak_mem_bytes']/2**30:.1f} |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dryrun-dir", default=str(ROOT / "build/dryrun"))
    ap.add_argument("--perf-dir", default=str(ROOT / "build/perf"))
    args = ap.parse_args(argv)
    recs = load(Path(args.dryrun_dir))
    print("### Single-pod 16x16 (256 ranks)\n")
    print(dryrun_table(recs, "16x16"))
    print("\n### Multi-pod 2x16x16 (512 ranks)\n")
    print(dryrun_table(recs, "2x16x16"))
    perf = load(Path(args.perf_dir))
    if perf:
        print("\n### Perf variants\n")
        print(perf_table(perf))


if __name__ == "__main__":
    main()
