"""selective_scan_roofline: the least time of every selective_scan call in
the traced slice (``roofline.scan_cost``: one a layer in each prefill, at
its rows, length, inner width and state) over the device time of its
kernels there, in percent."""
import re

from portbench.harness import roofline

KERNEL = re.compile(r"scan_chunk_kernel")


def read(run):
    sl, cfg = run.slice, run.config
    if sl is None or not cfg.get("ssm"):
        return None
    spent = sl.kernel_s(KERNEL)
    di = cfg["ssm"]["expand"] * cfg["d_model"]
    n = cfg["ssm"]["state_dim"]
    least = 0.0
    for _, _, _, _, rows, s in sl.slice_calls("prefill"):
        flops, nbytes, peak = roofline.scan_cost(rows, s, di, n, 2)
        least += cfg["num_layers"] * roofline.bound(flops, nbytes, peak)[0]
    return 100.0 * least / spent if spent and least else None
