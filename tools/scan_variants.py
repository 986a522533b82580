#!/usr/bin/env python3
"""Time selective_scan.cu against copies of itself with one part taken out.

    python3 tools/scan_variants.py [variant ...]      # on a CUDA card

Each variant is the kernel source with one text substitution: the exps
replaced by a multiply (`no_exps`), the B/C shared-memory reads replaced by
register values (`no_bc_reads`), the y stores made dead (`no_stores`), the
local pass of a chunked run skipped (`no_local_pass`), or one thread per
channel holding all 16 states (`one_thread_16_states`).  Only `base`
computes the scan; the others tell which part of the kernel sets its time.
Each is built with nvcc, bound through the wrapper's ctypes signature and
timed with CUDA events over 30 calls on three input sets, at Hymba-1.5B's
refill (B=1, S=2048) and wave (B=8, S=512) shapes (Di=3200, N=16, bf16 x),
with the chunk length of `selective_scan.py::chunk_len`.  Prints the card's
name and power limit, then one line per variant and shape.

A throwaway diagnostic, kept only so that the variant times in PERF.md can
be reproduced: no test or script runs it, and each substitution names exact
text of the kernel, so any later edit of selective_scan.cu may break a
variant (it then raises, naming the text it did not find).
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
SOURCE = ROOT / "src/repro_torch/kernels/selective_scan/csrc/selective_scan.cu"
OUT_DIR = ROOT / "build" / "scan_variants"           # gitignored

VARIANTS = {
    "base": [],
    "no_exps": [('asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));',
                 "y = x * 0.5f;")],
    "no_bc_reads": [
        ("          const float4 bb = bq[q];",
         "          const float4 bb = make_float4(dtv, 0.5f, 0.25f, xv);"),
        ("            const float4 cc = cq[q];",
         "            const float4 cc = make_float4(xv, 0.5f, 0.25f, dtv);")],
    "no_stores": [("if (kFull || writes) store(",
                   "if ((kFull || writes) && dsk == 12345.f) store(")],
    "no_local_pass": [("  if (chunks > 1) {\n    scan_chunk_kernel",
                       "  if (false) {\n    scan_chunk_kernel")],
    "one_thread_16_states": [("launch_vec<T, 8, 2>(",
                              "launch_vec<T, 16, 1>(")],
}
SHAPES = {"refill": (1, 2048, 3200, 16), "wave": (8, 512, 3200, 16)}


def build(name: str, subs, out_dir: Path) -> ctypes.CDLL:
    src = SOURCE.read_text()
    for old, new in subs:
        if old not in src:
            raise RuntimeError(f"variant {name}: {old!r} is not in "
                               f"{SOURCE.name}; update the substitution")
        src = src.replace(old, new)
    cu = out_dir / f"{name}.cu"
    cu.write_text(src)
    lib = out_dir / f"lib{name}.so"
    from repro_torch.kernels import _nvcc
    res = subprocess.run([_nvcc._nvcc(cu), *_nvcc.NVCC_FLAGS, "-o", str(lib),
                          str(cu)], capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed on variant {name}:\n{res.stderr}")
    handle = ctypes.CDLL(str(lib))
    from repro_torch.kernels.selective_scan import selective_scan as mod
    mod._bind(handle)
    return handle


def main() -> int:
    import torch
    from repro_torch.kernels.selective_scan.selective_scan import chunk_len
    if not torch.cuda.is_available():
        print("scan_variants: no CUDA device", file=sys.stderr)
        return 2
    names = sys.argv[1:] or list(VARIANTS)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)

    def inputs(b, s, di, n):
        r = lambda *shape: torch.randn(shape, generator=g, device="cuda")
        return [(0.5 * r(b, s, di)).bfloat16(),
                torch.nn.functional.softplus(r(b, s, di)),
                -torch.exp(0.3 * r(di, n)), (0.5 * r(b, s, n)).bfloat16(),
                (0.5 * r(b, s, n)).bfloat16(), torch.ones(di, device="cuda")]

    sets = {k: [inputs(*v) for _ in range(3)] for k, v in SHAPES.items()}

    def run(lib, x, dt, a, b, c, d, chunk):
        bsz, s, di = x.shape
        n = a.shape[1]
        chunks = -(-s // chunk)
        y = torch.empty_like(x)
        h_end = torch.empty((bsz, di, n), device="cuda")
        scratch = torch.empty((2, max(chunks - 1, 0), bsz, di, n),
                              device="cuda")
        err = lib.selective_scan_launch(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
            c.data_ptr(), d.data_ptr(), None, bsz, s, di, n, chunk, 1,
            scratch[0].data_ptr(), scratch[1].data_ptr(), y.data_ptr(),
            h_end.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed with CUDA error {err}")

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    for name in names:
        lib = build(name, VARIANTS[name], OUT_DIR)
        for shape, (b, s, di, n) in SHAPES.items():
            chunk = chunk_len(b, s, di, n)
            for i in range(10):                        # warm-up
                run(lib, *sets[shape][i % 3], chunk)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for i in range(30):
                run(lib, *sets[shape][i % 3], chunk)
            end.record()
            torch.cuda.synchronize()
            print(f"{name} {shape} B={b} S={s} Di={di} N={n} chunk={chunk} "
                  f"ms={start.elapsed_time(end) / 30:.6f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
