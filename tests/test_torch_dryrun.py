"""The port's dry-run (``repro_torch.launch.dryrun``) against the JAX
package's, and its launchers (``multihost``, ``autotune``), on the CPU.

Every plan runs over a fake default process group, which fixes the rank
count of its process, so each runs in a subprocess (as
``tests/test_parallel.py`` runs the reference's): one torch process plans
all the cases of this file and reports each case's result or traceback,
one JAX process lowers the reference's cells on 8 host devices.  Reduced
Llama (2 layers) at seq 64 x batch 8:
- the bytes a rank holds (params, AdamW state, batch) equal the JAX
  compiled step's ``argument_size_in_bytes`` exactly at (8, 1) and (4, 1);
- its FLOPs lie within FLOPS_RTOL of ``HloCostModel``'s at (8, 1), and
  at (4, 2), where the ``model`` axis splits the work (tensor-parallel
  activations) as it splits the reference's: a rank plans (8, 1)'s FLOPs.
- Reduced Mixtral (2 layers, its published 8 experts) at (4, 2), its
  experts over the ``model`` axis: its FLOPs a rank lie within
  FLOPS_RTOL of the JAX dry-run's; under the EP-2D rules
  (``launch.autotune.EP2D``) the same cell plans the same FLOPs, counts
  all-to-all bytes, and gathers fewer expert bytes (all-gather) and
  peaks lower than under the default rules, which gather a rank's
  experts over the data axis.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro_torch.configs import ARCH_IDS  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
FLOPS_RTOL = 0.03
PARITY_MESHES = ("8x1", "4x1", "4x2")
KINDS = ("train", "prefill", "decode")


def _run(code: str, env: dict, timeout: int = 300) -> str:
    env = {**os.environ, "PYTHONPATH": str(SRC), "JAX_PLATFORMS": "cpu",
           "OMP_NUM_THREADS": "1", "PYTHONWARNINGS": "ignore", **env}
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         capture_output=True, text=True, timeout=timeout,
                         env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


PLANS = """
import dataclasses, json, traceback
import torch
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import ParallelConfig, SHAPES, reduced
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
from repro_torch.parallel.sharding import AxisRules
from repro_torch.runtime.elastic import ElasticController

out = {}
def case(name, fn):
    try:
        out[name] = {"ok": True, "value": fn()}
    except Exception:
        out[name] = {"ok": False, "error": traceback.format_exc()[-3000:]}

def small(name, seq, batch):
    return dataclasses.replace(SHAPES[name], seq_len=seq, global_batch=batch)

TRAIN, PREFILL, DECODE = (small("train_4k", 64, 8), small("prefill_32k", 64, 8),
                          small("decode_32k", 128, 8))
llama = reduced(get_config("llama3_2_1b"), num_layers=2)

def grid(shape):
    dryrun.ensure_fake_world(shape[0] * shape[1])
    return make_mesh(shape, ("data", "model"))

def fake_step():
    # the sharded step itself under FakeTensorMode over a fake 8-rank group
    from torch._subclasses.fake_tensor import FakeTensorMode
    mesh = grid((4, 2))
    with FakeTensorMode():
        step, args = dryrun.build_lowerable(llama, TRAIN, mesh, AxisRules(),
                                            ParallelConfig())
        state, metrics = step(*args)
        return sorted(metrics)

def parity(shape):
    rec = dryrun.plan_cell(llama, TRAIN, grid(shape))
    return {"resident": rec["resident_bytes"],
            "flops": rec["roofline"]["flops_per_device"],
            "peak": rec["roofline"]["peak_mem_bytes"],
            "model_axis": rec["mesh_shape"].get("model", 1)}

def cell(cfg, shape, mesh):
    rec = dryrun.plan_cell(cfg, shape, mesh)
    return {k: rec[k] for k in ("status", "fits_hbm", "resident_bytes")} | {
        "roofline": {k: rec["roofline"][k] for k in (
            "t_compute", "t_memory", "t_collective", "bottleneck",
            "peak_mem_bytes", "flops_per_device", "coll_by_kind")},
        "kernel_calls": rec["roofline"]["extras"]["kernel_calls"]}

def elastic():
    ctl = ElasticController(model_parallel=2)
    dryrun.ensure_fake_world(8)
    first = cell(llama, TRAIN, ctl.form(list(range(8))))       # 4x2
    second = cell(llama, TRAIN, ctl.on_failure(list(range(4))))  # 2x2
    return {"generation": ctl.generation, "first": first, "second": second,
            "shapes": [e["shape"] for e in ctl.events]}

mixtral = reduced(get_config("mixtral_8x22b"), num_layers=2)
mixtral = dataclasses.replace(mixtral, moe=dataclasses.replace(
    mixtral.moe, num_experts=8))

def moe_cell(which):
    from repro_torch.launch.autotune import EP2D
    rules = AxisRules()
    for logical, axes in (EP2D if which == "ep2d" else ()):
        rules = rules.replacing(logical, axes)
    rec = dryrun.plan_cell(mixtral, TRAIN, grid((4, 2)), rules)
    return {"flops": rec["roofline"]["flops_per_device"],
            "peak": rec["roofline"]["peak_mem_bytes"],
            "coll": rec["roofline"]["coll_by_kind"]}

case("fake_step", fake_step)
case("mixtral_4x2_default", lambda: moe_cell("default"))
case("mixtral_4x2_ep2d", lambda: moe_cell("ep2d"))
for shape in ((8, 1), (4, 1), (4, 2)):
    case("parity_%dx%d" % shape, lambda: parity(shape))
case("small_train", lambda: cell(llama, TRAIN, grid((4, 2))))
case("small_decode", lambda: cell(reduced(get_config("yi_9b"), num_layers=2),
                                  DECODE, grid((4, 2))))
case("elastic", elastic)
for arch in ARCH_IDS:
    cfg = reduced(get_config(arch), num_layers=2)
    for kind, shape in (("train", TRAIN), ("prefill", PREFILL),
                        ("decode", DECODE)):
        case(f"{arch}/{kind}", lambda: cell(cfg, shape, grid((4, 2))))

def tune():
    # the reference's production cell, on a 2-layer config (last: it
    # swaps the configs the dry-run reads)
    from repro_torch.launch import autotune
    small = lambda arch: reduced(get_config(arch), num_layers=2)
    dryrun.get_config = autotune.get_config = small
    autotune.OUT_DIR = OUT_DIR
    summary = autotune.tune("yi_9b", "prefill_32k")
    return {"summary": summary,
            "written": sorted(f.name for f in OUT_DIR.glob("*.json"))}

case("autotune", tune)
print(json.dumps(out))
"""

JAX_PARITY = """
import dataclasses, json, os
import jax, numpy as np
from jax.sharding import Mesh
from repro.configs import get_config
from repro.configs.base import ParallelConfig, SHAPES, reduced
from repro.launch.autotune import candidates
from repro.launch.dryrun import build_lowerable
from repro.parallel.sharding import AxisRules
from repro.roofline.hlo_cost import HloCostModel
# the reference's launch modules set 512 host devices when imported;
# 8 are enough, and the backend reads the flag when it first starts
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
cfg = reduced(get_config("llama3_2_1b"), num_layers=2)
shape = dataclasses.replace(SHAPES["train_4k"], seq_len=64, global_batch=8)
out = {}
for d, m in ((8, 1), (4, 1), (4, 2)):
    mesh = Mesh(np.array(jax.devices()[:d * m]).reshape(d, m),
                ("data", "model"))
    jitted, args = build_lowerable(cfg, shape, mesh, AxisRules(),
                                   ParallelConfig())
    with mesh:
        compiled = jitted.lower(*args).compile()
    out[f"{d}x{m}"] = {
        "arg_bytes": compiled.memory_analysis().argument_size_in_bytes,
        "flops": HloCostModel(compiled.as_text()).cost().flops}
mix = reduced(get_config("mixtral_8x22b"), num_layers=2)
mix = dataclasses.replace(mix, moe=dataclasses.replace(mix.moe,
                                                       num_experts=8))
mesh = Mesh(np.array(jax.devices()[:8]).reshape(4, 2), ("data", "model"))
jitted, args = build_lowerable(mix, shape, mesh, AxisRules(),
                               ParallelConfig())
with mesh:
    compiled = jitted.lower(*args).compile()
out["mixtral_4x2"] = {"flops": HloCostModel(compiled.as_text()).cost().flops}
# the reference's autotune candidates (its module sets XLA_FLAGS when
# imported, so it is imported here, never in the test process)
out["candidates"] = {
    f"{arch}/{name}/{int(pod)}": [[c[0], c[1]] for c in candidates(
        get_config(arch), SHAPES[name], pod)]
    for arch, name in CANDIDATE_CELLS for pod in (False, True)}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def plans(tmp_path_factory):
    out = tmp_path_factory.mktemp("autotune")
    code = f"from pathlib import Path\nOUT_DIR = Path({str(out)!r})\n" + PLANS
    return json.loads(_run(code, {}).strip().splitlines()[-1])


@pytest.fixture(scope="module")
def jax_cells():
    flags = "--xla_force_host_platform_device_count=8"
    code = (f"CANDIDATE_CELLS = {sorted(REFERENCE_CANDIDATES)!r}\n"
            + JAX_PARITY)
    return json.loads(_run(code, {"XLA_FLAGS": flags})
                      .strip().splitlines()[-1])


def _value(plans, name):
    got = plans[name]
    assert got["ok"], got["error"]
    return got["value"]


def test_sharded_step_runs_on_fake_tensors(plans):
    """The sharded train step runs under FakeTensorMode over a fake
    8-rank group: it reads no device value on the host."""
    metrics = _value(plans, "fake_step")
    assert {"loss", "grad_norm", "lr"} <= set(metrics)


@pytest.mark.parametrize("mesh", ["8x1", "4x1"])
def test_rank_bytes_equal_jax_argument_bytes(plans, jax_cells, mesh):
    resident = _value(plans, f"parity_{mesh}")["resident"]
    assert set(resident) == {"params", "opt_state", "batch"}
    assert sum(resident.values()) == jax_cells[mesh]["arg_bytes"]


def test_rank_flops_match_jax_hlo_cost(plans, jax_cells):
    port = _value(plans, "parity_8x1")["flops"]
    assert port == pytest.approx(jax_cells["8x1"]["flops"], rel=FLOPS_RTOL)


def test_model_axis_divides_flops_as_jax(plans, jax_cells):
    port = _value(plans, "parity_4x2")
    assert port["model_axis"] == 2
    assert port["flops"] == pytest.approx(jax_cells["4x2"]["flops"],
                                          rel=FLOPS_RTOL)


def test_model_axis_repeats_the_work(plans):
    """The model axis no longer repeats the work: (4, 2) plans (8, 1)'s
    FLOPs a rank, half of (4, 1)'s, and its all-reduces of the
    row-parallel outputs count under their kind."""
    flops = {m: _value(plans, f"parity_{m}")["flops"] for m in PARITY_MESHES}
    assert flops["4x2"] == pytest.approx(flops["8x1"], rel=FLOPS_RTOL)
    assert flops["4x1"] == 2 * flops["8x1"]
    assert flops["4x2"] < flops["4x1"]
    coll = _value(plans, "small_train")["roofline"]["coll_by_kind"]
    assert coll["all-reduce"] > coll["reduce-scatter"]


def test_expert_parallel_flops_match_jax(plans, jax_cells):
    port = _value(plans, "mixtral_4x2_default")["flops"]
    assert port == pytest.approx(jax_cells["mixtral_4x2"]["flops"],
                                 rel=FLOPS_RTOL)


def test_ep2d_plan_exchanges_the_experts_work(plans):
    default = _value(plans, "mixtral_4x2_default")
    ep = _value(plans, "mixtral_4x2_ep2d")
    assert ep["flops"] == default["flops"]
    assert "all-to-all" not in default["coll"]
    assert ep["coll"]["all-to-all"] > 0
    assert ep["coll"]["all-gather"] < default["coll"]["all-gather"]
    assert ep["peak"] < default["peak"]


def test_dryrun_cell_small_mesh(plans):
    rec = _value(plans, "small_train")
    assert rec["status"] == "ok" and rec["fits_hbm"]
    r = rec["roofline"]
    assert r["flops_per_device"] > 0 and r["peak_mem_bytes"] > 0
    assert r["coll_by_kind"]["all-gather"] > 0
    assert r["coll_by_kind"]["reduce-scatter"] > 0
    assert rec["kernel_calls"] == {}          # training runs no kernel


def test_dryrun_decode_cell_small_mesh(plans):
    rec = _value(plans, "small_decode")
    assert rec["status"] == "ok"
    assert rec["resident_bytes"]["cache"] > 0
    assert rec["kernel_calls"] == {"decode_attention": 2}   # one a layer


def test_elastic_shrink_then_lower(plans):
    rec = _value(plans, "elastic")
    assert rec["generation"] == 2
    assert rec["shapes"] == [[4, 2], [2, 2]]
    assert rec["first"]["status"] == rec["second"]["status"] == "ok"


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_config_plans(plans, arch, kind):
    rec = _value(plans, f"{arch}/{kind}")
    assert rec["status"] == "ok"
    assert rec["roofline"]["t_memory"] > 0


# -- multihost ---------------------------------------------------------------

def test_detect_env_reads_slurm(monkeypatch):
    from repro_torch.launch import multihost
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT", "SLURM_JOB_ID"):
        monkeypatch.delenv(var, raising=False)
    assert multihost.detect_env() == {}
    monkeypatch.setenv("SLURM_JOB_ID", "77")
    monkeypatch.setenv("SLURM_PROCID", "9")
    monkeypatch.setenv("SLURM_NTASKS", "16")
    monkeypatch.setenv("SLURM_LOCALID", "1")
    monkeypatch.setenv("SLURM_STEP_NODELIST", "gpu-a[003-004,009],gpu-b")
    env = multihost.detect_env()
    assert env == {"rank": 9, "world_size": 16, "local_rank": 1,
                   "master_addr": "gpu-a003",
                   "master_port": multihost.MASTER_PORT}
    monkeypatch.setenv("MASTER_PORT", "29500")     # torchrun's own wins
    multihost.apply_env(env)
    assert (os.environ["RANK"], os.environ["WORLD_SIZE"],
            os.environ["LOCAL_RANK"], os.environ["MASTER_ADDR"],
            os.environ["MASTER_PORT"]) == ("9", "16", "1", "gpu-a003",
                                           "29500")
    assert multihost.first_host("node7") == "node7"


def test_multihost_main_two_gloo_ranks(tmp_path):
    from _torch_dist import spawn
    out = spawn("""
        import json
        from repro_torch.launch import multihost
        rec = multihost.main(["--preset", "smoke", "--batch", "4", "--seq",
                              "16", "--steps", "2", "--device", "cpu"])
        (out / f"rank{rank}.json").write_text(json.dumps(rec))
    """, world=2, tmp_path=tmp_path, timeout=120)
    recs = [json.loads((out / f"rank{r}.json").read_text()) for r in (0, 1)]
    assert [r["rank"] for r in recs] == [0, 1]
    assert all(r["mesh"] == {"data": 2, "model": 1} for r in recs)
    assert recs[0]["losses"] == recs[1]["losses"]      # metrics agree
    assert all(len(r["losses"]) == 2 and r["peak_bytes"] is None
               for r in recs)


# -- autotune ----------------------------------------------------------------

REFERENCE_CANDIDATES = {
    ("llama3_2_1b", "train_4k"): ["default", "micro4", "micro8",
                                  "micro8+optbf16"],
    ("yi_9b", "prefill_32k"): ["default", "seq_parallel"],
    ("deepseek_v3_671b", "decode_32k"): ["default", "ep2d"],
    ("deepseek_v3_671b", "train_4k"): ["default", "micro4", "micro8",
                                       "micro8+optbf16", "ep2d",
                                       "ep2d+micro8+optbf16"],
    ("mixtral_8x22b", "train_4k"): ["default", "micro4", "micro8",
                                    "micro8+optbf16"],
}


@pytest.mark.parametrize("arch,shape", sorted(REFERENCE_CANDIDATES))
def test_autotune_candidates_match_reference(jax_cells, arch, shape):
    from repro_torch.configs import get_config
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch import autotune
    for multi_pod in (False, True):
        port = autotune.candidates(get_config(arch), SHAPES[shape], multi_pod)
        ref = jax_cells["candidates"][f"{arch}/{shape}/{int(multi_pod)}"]
        as_lists = lambda rules: json.loads(json.dumps(rules))
        assert [c[0] for c in port] == [c[0] for c in ref] \
            == REFERENCE_CANDIDATES[arch, shape]
        assert [as_lists(c[1]) for c in port] == [c[1] for c in ref]


def test_autotune_tunes_a_reduced_cell(plans):
    got = _value(plans, "autotune")
    rec = got["summary"]
    assert set(rec["candidates"]) == {"default", "seq_parallel"}
    assert rec["best"] in rec["candidates"]
    # sequence parallelism plans what it names: the residual's slices
    # lower a rank's peak below the default rules'
    cands = rec["candidates"]
    assert "note" not in rec
    assert cands["seq_parallel"]["peak_gib"] < cands["default"]["peak_gib"]
    assert "yi_9b__prefill_32k__16x16.json" in got["written"]
