"""pass_ms: the window's milliseconds over the loop passes that decoded in
it (the delta of the engine's ``decode_passes``): admit, refills,
sampling, bookkeeping and the decode step of one pass."""


def read(run):
    passes = run.delta["decode_passes"]
    return run.window_s * 1e3 / passes if passes else None
