"""mfu.serve: useful model FLOPs of the window over the window's seconds
times the card's bf16 peak, in percent.  Useful: the prompts prefilled in
the window (every token through the layers, causal attention, the head at
the last position) and one token of each decode row that moved on
(``harness/roofline.py``); padded and finished rows count nothing."""
from portbench.harness import roofline


def read(run):
    if not any(c[0] == "decode" for c in run.calls):
        return None
    flops = 0.0
    for c in run.calls:
        if c[0] == "prefill":
            flops += roofline.prefill_flops(run.config, c[4], c[5])
        else:
            pos, moved = c[4], c[5]
            flops += roofline.decode_flops(run.config, pos[moved])
    return 100.0 * flops / (run.window_s * roofline.PEAK_BF16_FLOPS)
