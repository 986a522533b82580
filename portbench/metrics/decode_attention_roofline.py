"""decode_attention_roofline: the least time of every decode_attention
call in the traced slice (``roofline.attention_cost``: one a layer in
each decode step, over all the cache's rows, each row's valid slots its
position + 1, at most the window) over the device time of its kernels
there, in percent."""
import re

import numpy as np

from portbench.harness import roofline

KERNEL = re.compile(r"decode_attn_kernel")


def read(run):
    sl, cfg = run.slice, run.config
    if sl is None or cfg.get("attention", "gqa") != "gqa":
        return None
    spent = sl.kernel_s(KERNEL)
    d, nq = cfg["d_model"], cfg["num_heads"]
    h = cfg.get("head_dim") or d // nq
    w = cfg.get("sliding_window", 0)
    slots = min(run.mix["max_len"], w) if w else run.mix["max_len"]
    least = 0.0
    for c in sl.slice_calls("decode"):
        pos = c[4]
        valid = int(np.minimum(pos + 1, slots).sum())
        flops, nbytes, peak = roofline.attention_cost(
            len(pos), slots, nq, cfg["num_kv_heads"], h, 2, valid)
        least += cfg["num_layers"] * roofline.bound(flops, nbytes, peak)[0]
    return 100.0 * least / spent if spent and least else None
