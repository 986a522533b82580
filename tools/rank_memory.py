"""The device memory of one model rank of a (1, 4) pilot mesh serving
Mixtral-8x22B at its published config and all 56 layers, on one card.

    python3 tools/rank_memory.py

It draws rank 0's leaves as the serving engine draws them over a pilot mesh
(``transformer.local_draw``), then, for each batch size of `BATCHES`,
runs a prefill wave of that many 4608-token prompts (the longest of the
four-card cell's) into a cache of `MAX_LEN` and one decode step under a
sharding context over ``chip_smoke.RankView`` (a one-rank process group,
so every model-axis all-reduce sums this rank alone) and prints the peak
``max_memory_allocated`` of each, or that it ran out of memory: which
batch the cell can serve, without holding four cards.  NCCL's buffers
of a real four-card group are not in the count.
"""
from __future__ import annotations

import datetime
import gc
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from chip_smoke import RankView, card_line, free_port  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.common import leaf_seed  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.models.transformer import local_draw, tp_layouts  # noqa: E402
from repro_torch.parallel.sharding import (AxisRules,  # noqa: E402
                                           sharding_context)
from repro_torch.serving.engine import (flatten_params,  # noqa: E402
                                        unflatten_params)

ARCH = "mixtral_8x22b"
RANKS, SEQ, MAX_LEN, BATCHES = 4, 4608, 8192, (2, 4, 8)


def main() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("tools/rank_memory.py runs on a CUDA card")
    from repro_torch.kernels.decode_attention import \
        decode_attention as attn_mod
    from repro_torch.kernels.flash_attention import \
        flash_attention as flash_mod
    for build, load in ((attn_mod.build, attn_mod.load),
                        (flash_mod.build_tc, flash_mod.load_tc)):
        build()
        load()
    cfg = get_config(ARCH)
    model = build_model(cfg)
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=600))
    out = {"arch": cfg.name, "layers": cfg.num_layers, "ranks": RANKS,
           "seq": SEQ, "card": card_line()}
    try:
        view, rules = RankView(RANKS, 0), AxisRules()
        specs = flatten_params(model.specs)
        lays = dict(flatten_params(tp_layouts(model.specs, cfg)))
        gen = torch.Generator(device=dev).manual_seed(0)
        t0 = time.perf_counter()
        params = unflatten_params([p for p, _ in specs], [
            local_draw(s, leaf_seed(gen), lays[p], view, rules, dev)
            for p, s in specs])
        torch.cuda.synchronize()
        out["draw_s"] = time.perf_counter() - t0
        out["weights_bytes"] = torch.cuda.memory_allocated()
        out["card_bytes"] = torch.cuda.get_device_properties(0).total_memory
        print(f"rank 0 of {RANKS}: {cfg.name} at {cfg.num_layers} "
              f"layers, {out['weights_bytes'] / 1e9:.3f} GB allocated, "
              f"drawn in {out['draw_s']:.1f} s, of "
              f"{out['card_bytes'] / 1e9:.3f} GB", flush=True)
        for b in BATCHES:
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            key = f"batch_{b}"
            try:
                with sharding_context(view, rules):
                    tokens = torch.randint(0, cfg.vocab_size, (b, SEQ),
                                           device=dev, dtype=torch.int32)
                    logits, cache = model.prefill(params, {"tokens": tokens},
                                                  MAX_LEN)
                    prefill_peak = torch.cuda.max_memory_allocated()
                    pos = torch.full((b,), SEQ, dtype=torch.int32,
                                     device=dev)
                    model.decode(params, cache,
                                 logits.argmax(-1, keepdim=True).to(
                                     torch.int32), pos)
                    torch.cuda.synchronize()
                out[key] = {"prefill_peak_bytes": prefill_peak,
                            "peak_bytes": torch.cuda.max_memory_allocated()}
                del logits, cache
            except torch.cuda.OutOfMemoryError:
                out[key] = "out of memory"
            print(key, out[key], flush=True)
    finally:
        dist.destroy_process_group()
    print(out, flush=True)
    return out


if __name__ == "__main__":
    main()
