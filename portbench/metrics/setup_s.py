"""setup_s: process start to the window's opening: imports, the weights,
deploy, the first wave and warm-up."""


def read(run):
    return run.setup_s
