"""LM serving ON the pilot substrate, on the PyTorch port: tiered shards +
KV pages, replica routing, continuous batching with refill, and
mid-stream recovery.

    PYTHONPATH=src python examples/torch/serve_lm.py [--arch yi_9b] \
        [--pilots 2] [--device cpu]

The port of ``examples/serve_lm.py``, through
``repro_torch.launch.serve.main``.  The model's parameter shards and each
request's KV-page trail live as tiered Pilot-Data partitions; every pilot
runs its decode loop as a long-lived resident task; requests route to
replicas through the session's SchedulingPolicy.  ``main(argv)`` returns
the engine's stats (with every request's tokens).
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

from repro_torch.launch.serve import main as serve_main


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3_2_1b")
    ap.add_argument("--preset", default="smoke")
    ap.add_argument("--pilots", default="2")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    stats = serve_main(["--arch", args.arch, "--preset", args.preset,
                        "--requests", "16", "--batch", "4",
                        "--prompt-len", "16", "--gen", "32",
                        "--max-len", "128", "--pilots", args.pilots]
                       + (["--device", args.device] if args.device else []))
    assert stats["completed"] == 16 and stats["tokens_served"] == 16 * 32
    return stats


if __name__ == "__main__":
    main()
