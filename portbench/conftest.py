"""Fixtures of the benchmark's CPU tests: a checkout of one tiny cell.

`tiny_root(family, dtype)` writes a ``BENCHMARK.json`` with one cell,
``tiny.mix``, its configuration (2 layers at toy widths), its traffic (5
clients on 4 rows, prompts of 8-24 tokens, 2-6 out) and its limits into a
temporary directory, which ``harness/cell.run`` takes as its root: the
files and entries alone make the cell.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = {
    "dense": dict(reference="dense", family="dense", attention="gqa",
                  num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                  head_dim=16, d_ff=128, vocab_size=256, ffn_act="gelu",
                  rope_theta=1e6, sliding_window=0),
    "ssm": dict(reference="ssm", family="ssm", attention="none",
                num_layers=2, d_model=64, num_heads=1, num_kv_heads=1,
                d_ff=0, vocab_size=256,
                ssm=dict(state_dim=4, conv_kernel=4, expand=2, dt_rank=8)),
}
TINY_MIX = dict(loop="closed", clients=5, rows=4, max_len=64, page_tokens=4,
                prompt=dict(dist="log_uniform", low=8, high=24, levels=5),
                output=dict(dist="uniform", low=2, high=6, levels=5),
                warmup_completions=4, check_tokens=30)
# fp32 on the CPU: the program and the reference agree to rounding
TINY_LIMIT = 1e-3


def write_root(root: Path, family: str, dtype: str = "float32",
               **changes) -> Path:
    cfg = dict(TINY[family], name=f"tiny-{family}", dtype=dtype, **changes)
    files = {
        f"portbench/configs/tiny-{family}.json": cfg,
        "portbench/traffic/tiny.json": TINY_MIX,
        "portbench/limits/tiny.mix.json": {
            "max_logit_gap": {"limit": TINY_LIMIT}},
        "BENCHMARK.json": {
            "command": ["python3", "portbench/run.py"],
            "paths": ["portbench"], "run_seconds": 1,
            "configs": [{"name": f"tiny-{family}", "source": "a test",
                         "file": f"portbench/configs/tiny-{family}.json",
                         "reduced": [], "why": "a test"}],
            "workloads": [{"name": "tiny.mix", "config": f"tiny-{family}",
                           "traffic": "tiny", "chips": 1, "why": "a test"}],
            "end_to_end": [{"name": "gen_tok_s", "unit": "tokens/s",
                            "better": "higher", "bound": 0.05,
                            "source": "host_clock"}],
            "per_layer": [{"name": "pass_ms", "unit": "ms",
                           "better": "lower", "source": "program_counter",
                           "layer": "Serving engine",
                           "moves": "gen_tok_s"}]},
    }
    for rel, obj in files.items():
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(obj))
    return root


@pytest.fixture
def tiny_root(tmp_path):
    return lambda family, dtype="float32", **kw: write_root(
        tmp_path, family, dtype, **kw)
