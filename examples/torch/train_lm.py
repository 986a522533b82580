"""End-to-end LM training through the full stack, on the PyTorch port.

    PYTHONPATH=src python examples/torch/train_lm.py [--device cpu]
    PYTHONPATH=src python examples/torch/train_lm.py --preset 100m \
        --steps 300

The port of ``examples/train_lm.py``, through
``repro_torch.launch.train.main``: a pilot -> file-tier corpus -> host
staging -> the train step as a compute unit -> async checkpoints (in a
temporary directory).  Every assigned arch works via --arch (smoke-scaled
variants of its family).  ``main(argv)`` returns the final loss; the
losses of every ``--log-every`` step are printed.
"""
import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

from repro_torch.launch.train import main as train_main


def main(argv=None) -> float:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3_2_1b")
    ap.add_argument("--preset", default="smoke")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="train_lm_example") as ck:
        return train_main(["--arch", args.arch, "--preset", args.preset,
                           "--steps", str(args.steps),
                           "--batch", str(args.batch),
                           "--seq", str(args.seq), "--lr", "1e-2",
                           "--ckpt-dir", ck, "--log-every", "20"]
                          + (["--device", args.device] if args.device
                             else []))


if __name__ == "__main__":
    main()
