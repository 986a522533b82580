"""rows_per_pass: tokens served in the window over its loop passes: the
rows a pass serves on average."""


def read(run):
    passes = run.delta["decode_passes"]
    return run.delta["tokens_served"] / passes if passes else None
