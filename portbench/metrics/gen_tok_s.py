"""gen_tok_s: new tokens the engine served in the window (the delta of
its ``tokens_served`` counter) over the window's seconds."""


def read(run):
    return run.delta["tokens_served"] / run.window_s
