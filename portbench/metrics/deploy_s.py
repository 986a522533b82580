"""deploy_s: host seconds of ``ServingEngine.deploy()`` and
``wait_ready()``: the weights sharded into Pilot-Data, replicated to the
pilot and rebuilt on its card."""


def read(run):
    return run.deploy_s
