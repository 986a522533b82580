"""A rank's FLOPs and collective bytes, by kind, in the port's dry-run and
the JAX package's (its compiled HLO, ``roofline.hlo_cost``), for the
cells of tests/test_torch_sp.py's plans: the Yi-like reduced prefill (2
layers, 8 x 64) and reduced Llama's train cell (8 x 64) on a (4, 2) data
x model mesh, under the default rules and under ``("seq", "model")``.
Both packages do the same work a rank; their layouts differ (the port
keeps Megatron's heads split and moves the residual's sequence, GSPMD
gives ``model`` to the sequence first and gathers weights), and so do
the bytes.

    PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/_sp_plan_bytes.py
"""
import json

from test_torch_sp import SP, _run_plans

CELLS = (("yi_9b", "prefill_32k"), ("llama3_2_1b", "train_4k"))

PORT = """
import dataclasses, json
from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES, reduced
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
from repro_torch.parallel.sharding import AxisRules
dryrun.ensure_fake_world(8)
mesh = make_mesh((4, 2), ("data", "model"))
out = {}
for arch, name in CELLS:
    for label, over in (("default", ()), ("sp", SP)):
        rules = AxisRules()
        for logical, axes in over:
            rules = rules.replacing(logical, axes)
        shape = dataclasses.replace(SHAPES[name], seq_len=64, global_batch=8)
        rec = dryrun.plan_cell(reduced(get_config(arch), num_layers=2),
                               shape, mesh, rules)
        out[f"{arch}/{label}"] = {
            "flops": rec["roofline"]["flops_per_device"],
            "coll": rec["roofline"]["coll_by_kind"]}
print(json.dumps(out))
"""

REF = """
import dataclasses, json, os
import jax, numpy as np
from jax.sharding import Mesh
from repro.configs import get_config
from repro.configs.base import ParallelConfig, SHAPES, reduced
from repro.launch.dryrun import build_lowerable
from repro.parallel.sharding import AxisRules
from repro.roofline.hlo_cost import HloCostModel
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
mesh = Mesh(np.array(jax.devices()[:8]).reshape(4, 2), ("data", "model"))
out = {}
for arch, name in CELLS:
    for label, over in (("default", ()), ("sp", SP)):
        rules = AxisRules()
        for logical, axes in over:
            rules = rules.replacing(logical, axes)
        shape = dataclasses.replace(SHAPES[name], seq_len=64, global_batch=8)
        jitted, args = build_lowerable(reduced(get_config(arch), num_layers=2),
                                       shape, mesh, rules, ParallelConfig())
        with mesh:
            cost = HloCostModel(jitted.lower(*args).compile().as_text()).cost()
        out[f"{arch}/{label}"] = {"flops": cost.flops,
                                  "coll": dict(cost.coll_by_kind)}
print(json.dumps(out))
"""


def main():
    head = f"SP, CELLS = {SP!r}, {CELLS!r}\n"
    port = _run_plans(head + PORT, {})
    ref = _run_plans(head + REF, {
        "XLA_FLAGS": "--xla_force_host_platform_device_count=8"})
    for key in port:
        print(json.dumps({"cell": key, "port": port[key], "jax": ref[key]}))


if __name__ == "__main__":
    main()
