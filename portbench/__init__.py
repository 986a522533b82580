"""The benchmark of ``repro_torch`` on an NVIDIA card.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name: ``BENCHMARK.json`` at the
checkout's root names the cells, ``configs/<config>.json`` holds a model
configuration as it is run, ``traffic/<traffic>.json`` the parameters of a
traffic mix, ``metrics/<metric>.py`` the reader of one metric,
``reference/<family>.py`` the plain fp32 forward pass of a model family,
and ``limits/<workload>.json`` the limits of a cell's output check.
``harness/`` is the general code: the traffic generator, the weights, the
closed loop of clients, the profiler slice, the frozen roofline arithmetic and
the output check.  Nothing here imports JAX or the JAX package ``repro``.
"""
