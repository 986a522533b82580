"""flash_attention_roofline: the least time of every flash_attention call
in the traced slice (``roofline.flash_cost``: one a layer in each prefill,
at the prefill's rows and length, causal within the config's window)
over the device time of its kernels there, in percent."""
import re

from portbench.harness import roofline

KERNEL = re.compile(r"flash_tc_kernel|flash_kernel")


def read(run):
    sl, cfg = run.slice, run.config
    if sl is None or cfg.get("attention", "gqa") != "gqa":
        return None
    spent = sl.kernel_s(KERNEL)
    d, nq = cfg["d_model"], cfg["num_heads"]
    h = cfg.get("head_dim") or d // nq
    least = 0.0
    for _, _, _, _, rows, s in sl.slice_calls("prefill"):
        flops, nbytes, peak, _ = roofline.flash_cost(
            rows, s, s, nq, cfg["num_kv_heads"], h, 2, True,
            cfg.get("sliding_window", 0))
        least += cfg["num_layers"] * roofline.bound(flops, nbytes, peak)[0]
    return 100.0 * least / spent if spent and least else None
