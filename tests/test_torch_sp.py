"""Sequence parallelism over the ``model`` axis (the rule ``("seq",
"model")``, ``launch.autotune.SP``) against the JAX package, on 4 gloo
ranks on the CPU (tests/_torch_dist.py).

- The sharded train step under the SP rules on reduced Llama, Mixtral,
  Falcon-Mamba, Hymba (5 q heads, 1 kv head: its attention whole on every
  rank) and DeepSeek-V3 (its dense FFN at the reduced width, as
  tests/test_torch_ep.py takes it), over (2, 2) and (1, 4) data x model
  meshes: the metrics of 3 steps (loss and grad norm among them) at rtol
  1e-5 and the params after them at rtol 1e-4, atol 1e-6 against the JAX
  package's ``make_train_step`` jitted over a (2, 2) mesh of 4 host
  devices under the same rules (the tolerances of
  tests/test_torch_tp.py's and tests/test_torch_parallel.py's cases);
  between blocks a rank's residual is S/M long.  Whisper (its decoder
  sequence-parallel, its encoder whole) and InternVL2 (the patches
  before the text) are held to the port's unsharded step.
- The prefill step under the same rules (every rank given the whole
  batch): its last-token logits and its cache (each rank's kv heads or
  SSM channels, over the whole sequence) against the JAX package's
  prefill jitted under those rules, at rtol 1e-4, atol 1e-5.
- A length the ``model`` axis does not divide runs unsharded: the step
  under the SP rules then computes what it computes under the default
  rules, bit for bit, on residuals of the whole length.
- The dry-run at (4, 2) under the SP rules, on the Yi-like reduced
  prefill and on reduced Llama's train cell: a rank's FLOPs within
  FLOPS_RTOL of the JAX dry-run's under those rules, and a planned peak
  below the default rules' plan; every config plans its train and
  prefill cells under them.
- ``gpu`` (``pytest --noconftest -m gpu``, four cards, no JAX): NCCL
  over (1, 4) under the SP rules trains 3 fp32 steps of reduced Llama as
  the unsharded step does on each card, at the tolerances above.
"""
import json
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_dist import run_jax, spawn  # noqa: E402
from repro_torch.configs import ARCH_IDS  # noqa: E402

STEP_CFG = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10)
FLOPS_RTOL = 0.03
SP = (("seq", "model"),)
# family -> (config overrides, MoE overrides), both packages' reduced
# configs; held to the JAX step unless marked "port"
FAMILIES = {
    "llama3_2_1b": ({}, {}),
    "mixtral_8x22b": ({}, {}),
    "falcon_mamba_7b": ({}, {}),
    "hymba_1_5b": ({"num_heads": 5, "num_kv_heads": 1}, {}),
    "deepseek_v3_671b": ({}, {"first_dense_d_ff": 128}),
}
PORT_ONLY = ("whisper_base", "internvl2_2b")
MESHES = ((2, 2), (1, 4))
CASES = [(arch, mesh) for arch in list(FAMILIES) + list(PORT_ONLY)
         for mesh in MESHES]
B, S, MAX_LEN = 4, 16, 32


def _case_name(arch, mesh):
    return f"{arch}-{mesh[0]}x{mesh[1]}"


def _inputs(arch):
    """(the JAX init in fp32 as numpy, rescaled as tests/test_torch_train.py
    takes it; the port's config; 3 batches; a prompt batch)."""
    import dataclasses
    import jax
    from repro.configs import get_config as ref_get_config
    from repro.configs.base import reduced as ref_reduced
    from repro.models.common import ParamSpec as RefParamSpec
    from repro.models.model import build_model as ref_build_model
    from repro_torch.configs import get_config
    from repro_torch.configs.base import reduced
    from test_torch_train import _batch, _fan_in_scale

    over, moe = FAMILIES.get(arch, ({}, {}))
    rcfg = ref_reduced(ref_get_config(arch), dtype="float32", **over)
    pcfg = reduced(get_config(arch), dtype="float32", **over)
    if moe:
        rcfg = dataclasses.replace(rcfg, moe=dataclasses.replace(rcfg.moe,
                                                                 **moe))
        pcfg = dataclasses.replace(pcfg, moe=dataclasses.replace(pcfg.moe,
                                                                 **moe))
    ref = ref_build_model(rcfg)
    params = jax.tree.map(
        lambda spec, leaf: np.asarray(leaf, np.float32)
        * np.float32(_fan_in_scale(spec)),
        ref.specs, ref.init(jax.random.key(0)),
        is_leaf=lambda x: isinstance(x, RefParamSpec))
    batches = [_batch(pcfg, b=B, s=S, seed=10 + i) for i in range(3)]
    prompt = {k: v for k, v in _batch(pcfg, b=B, s=S, seed=20).items()
              if k != "labels"}
    return params, pcfg, batches, prompt


JAX_SP = """
import dataclasses, pickle
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.configs.base import ParallelConfig, ShapeConfig, TrainConfig, reduced
from repro.launch.mesh import make_mesh
from repro.models.common import param_pspecs
from repro.models.model import build_model
from repro.optim.adamw import OptState, adamw_init
from repro.parallel.sharding import AxisRules, sharding_context
from repro.train import steps
inputs = pickle.load(open(IN, "rb"))
rules = AxisRules()
for logical, axes in SP:
    rules = rules.replacing(logical, axes)
mesh = make_mesh((2, 2), ("data", "model"))
ns = lambda tree: jax.tree.map(lambda p: NamedSharding(mesh, p), tree)
out = {}
for arch, (params, batches, prompt) in inputs.items():
    over, moe = FAMILIES[arch]
    cfg = reduced(get_config(arch), dtype="float32", **over)
    if moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **moe))
    model = build_model(cfg)
    pps = param_pspecs(model.specs, mesh, rules)
    shape = ShapeConfig("train", S + cfg.vision_tokens, B, "train")
    _, bps = steps.batch_specs(cfg, shape, mesh, rules)
    step = steps.make_train_step(model, ParallelConfig(),
                                 TrainConfig(**STEP_CFG))
    def fn(state, batch, step=step):
        with sharding_context(mesh, rules):
            return step(state, batch)
    jitted = jax.jit(fn, in_shardings=(steps.TrainState(ns(pps), OptState(
        ns(pps), ns(pps), NamedSharding(mesh, P()))), ns(bps)))
    jp = jax.tree.map(jnp.asarray, params)
    state = steps.TrainState(jp, adamw_init(jp))
    metrics = []
    with mesh:
        for batch in batches:
            state, m = jitted(state, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
            metrics.append({k: float(v) for k, v in m.items()})
    pshape = ShapeConfig("prefill", S + cfg.vision_tokens, B, "prefill")
    _, pbps = steps.batch_specs(cfg, pshape, mesh, rules)
    prefill = steps.make_prefill_step(model, MAX_LEN)
    def pfn(params, batch, prefill=prefill):
        with sharding_context(mesh, rules):
            return prefill(params, batch)
    with mesh:
        logits, cache = jax.jit(pfn, in_shardings=(ns(pps), ns(pbps)))(
            jp, {k: jnp.asarray(v) for k, v in prompt.items()})
    out[arch] = (metrics, [np.asarray(x) for x in
                           jax.tree.leaves(state.params)],
                 np.asarray(logits), [np.asarray(x) for x in
                                      jax.tree.leaves(cache)])
pickle.dump(out, open(OUT, "wb"))
"""

PORT_SP = """
import json, pickle
from repro_torch.carry import params_from_numpy
from repro_torch.configs.base import ParallelConfig, TrainConfig
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import transformer
from repro_torch.models.common import gather_vocab, tree_leaves
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import adamw_init
from repro_torch.parallel.sharding import AxisRules, sharding_context
from repro_torch.serving.engine import flatten_params, unflatten_params
from repro_torch.train import steps
inputs = pickle.loads(Path(IN).read_bytes())
want = pickle.loads(Path(JAX).read_bytes())
tcfg = TrainConfig(**STEP_CFG)
sp = AxisRules()
for logical, axes in SP:
    sp = sp.replacing(logical, axes)
lengths = []
def recorded(layer):
    def run(lp, x, *a, **k):
        lengths.append(x.shape[1])
        return layer(lp, x, *a, **k)
    return run
transformer.layer_forward = recorded(transformer.layer_forward)
transformer._encdec_layer = recorded(transformer._encdec_layer)

def train(model, params, mesh, rules, batches):
    state = steps.shard_train_state(
        steps.TrainState(params, adamw_init(params)),
        steps.train_state_shardings(model, mesh, rules))
    step = steps.make_sharded_train_step(model, ParallelConfig(), tcfg,
                                         mesh, rules)
    metrics = []
    for batch in batches:
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in batch.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, [t.numpy() for t in
                     tree_leaves(steps.gather_state(state.params))]

def unsharded(model, params, batches):
    step = steps.make_train_step(model, ParallelConfig(), tcfg)
    state = steps.TrainState(params, adamw_init(params))
    metrics = []
    for batch in batches:
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in batch.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, [t.numpy() for t in tree_leaves(state.params)]

def prefill(model, params, mesh, prompt):
    specs = dict(flatten_params(model.specs))
    lays = dict(flatten_params(transformer.tp_layouts(model.specs,
                                                      model.cfg)))
    pairs = flatten_params(params)
    local = unflatten_params([p for p, _ in pairs], [
        transformer.local_leaf(t, specs[p], lays[p], mesh, sp)
        for p, t in pairs])
    with sharding_context(mesh, sp):
        logits, cache = model.prefill(
            local, {k: torch.from_numpy(v) for k, v in prompt.items()},
            MAX_LEN)
        logits = gather_vocab(logits, model.cfg.vocab_size)
    return logits.numpy(), [t.numpy() for t in tree_leaves(cache)]

results = {}
for arch, shape in CASES:
    params, cfg, batches, prompt = inputs[arch]
    model = build_model(cfg)
    mesh = make_mesh(shape, ("data", "model"))
    lengths.clear()
    metrics, leaves = train(model, params_from_numpy(params, "cpu"), mesh,
                            sp, batches)
    residual = sorted(set(lengths))
    if arch in want:
        ref_metrics, ref_leaves = want[arch][:2]
    else:
        ref_metrics, ref_leaves = unsharded(
            model, params_from_numpy(params, "cpu"), batches)
    errs = {}
    for got, ref in zip(metrics, ref_metrics):
        assert sorted(got) == sorted(ref), (got, ref)
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=1e-8,
                                       err_msg=f"{arch} {shape} {k}")
    assert len(leaves) == len(ref_leaves)
    for g, w in zip(leaves, ref_leaves):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6,
                                   err_msg=f"{arch} {shape}")
    if arch in want:
        logits, cache = prefill(model, params_from_numpy(params, "cpu"),
                                mesh, prompt)
        ref_logits, ref_cache = want[arch][2:]
        np.testing.assert_allclose(logits, ref_logits, rtol=1e-4, atol=1e-5,
                                   err_msg=f"{arch} {shape} logits")
        m, r = shape[1], mesh.get_local_rank("model")
        assert len(cache) == len(ref_cache)
        for got, ref in zip(cache, ref_cache):
            # a rank's heads or channels: block r * whole / (M * local)
            # of the whole (heads that do not divide the axis: the ones
            # its q heads read, attention.kv_select)
            index = []
            for d, (n_loc, n) in enumerate(zip(got.shape, ref.shape)):
                lo = r * n // (m * n_loc) * n_loc if n_loc < n else 0
                index.append(slice(lo, lo + n_loc))
            np.testing.assert_allclose(got, ref[tuple(index)], rtol=1e-4,
                                       atol=1e-5,
                                       err_msg=f"{arch} {shape} cache")
    results[f"{arch}-{shape[0]}x{shape[1]}"] = residual

# a length the model axis does not divide: the default rules' numbers
arch = "llama3_2_1b"
params, cfg, batches, _ = inputs[arch]
odd = ODD_BATCHES
model = build_model(cfg)
mesh = make_mesh((2, 2), ("data", "model"))
lengths.clear()
runs = [train(model, params_from_numpy(params, "cpu"), mesh, rules, odd)
        for rules in (sp, AxisRules())]
results["odd"] = sorted(set(lengths))
assert runs[0][0] == runs[1][0]
for a, b in zip(runs[0][1], runs[1][1]):
    np.testing.assert_array_equal(a, b)
if rank == 0:
    (out / "residual.json").write_text(json.dumps(results))
"""


@pytest.fixture(scope="module")
def sp_runs(tmp_path_factory):
    """Every case's residual lengths from 4 ranks, which checked their
    steps and prefills against the JAX package's (or the port's
    unsharded step) as they ran."""
    from test_torch_train import _batch
    tmp = tmp_path_factory.mktemp("sp")
    inputs = {arch: _inputs(arch) for arch in list(FAMILIES) + list(PORT_ONLY)}
    jax_in = {arch: (params, batches, prompt)
              for arch, (params, _, batches, prompt) in inputs.items()
              if arch in FAMILIES}
    (tmp / "jax_in.pkl").write_bytes(pickle.dumps(jax_in))
    head = (f"IN, OUT = {str(tmp / 'jax_in.pkl')!r}, "
            f"{str(tmp / 'jax.pkl')!r}\n"
            f"FAMILIES, SP, STEP_CFG = {FAMILIES!r}, {SP!r}, {STEP_CFG!r}\n"
            f"B, S, MAX_LEN = {B}, {S}, {MAX_LEN}\n")
    run_jax(head + JAX_SP, devices=4, timeout=600)
    (tmp / "in.pkl").write_bytes(pickle.dumps(inputs))
    odd = [_batch(inputs["llama3_2_1b"][1], b=B, s=S + 1, seed=30 + i)
           for i in range(2)]
    head = ("import pickle\n"
            f"IN, JAX = {str(tmp / 'in.pkl')!r}, {str(tmp / 'jax.pkl')!r}\n"
            f"CASES, SP, STEP_CFG = {CASES!r}, {SP!r}, {STEP_CFG!r}\n"
            f"S, MAX_LEN = {S}, {MAX_LEN}\n"
            f"ODD_BATCHES = pickle.loads({pickle.dumps(odd)!r})\n")
    out = spawn(head + PORT_SP, world=4, tmp_path=tmp, timeout=900)
    return json.loads((out / "residual.json").read_text())


@pytest.mark.parametrize("case", CASES, ids=[_case_name(*c) for c in CASES])
def test_sequence_parallel_step_matches_the_reference(case, sp_runs):
    """Each case's steps and prefill held to the reference on the ranks
    (an assertion there fails the fixture); here: the residual between
    blocks was a rank's S/M slice."""
    arch, mesh = case
    vision = 4 if arch == "internvl2_2b" else 0      # reduced InternVL2's
    assert sp_runs[_case_name(*case)] == [(S + vision) // mesh[1]]


def test_a_length_the_axis_does_not_divide_runs_unsharded(sp_runs):
    assert sp_runs["odd"] == [S + 1]


# -- the dry-run ----------------------------------------------------------------
PLANS = """
import dataclasses, json, traceback
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import SHAPES, reduced
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
from repro_torch.parallel.sharding import AxisRules

out = {}
def case(name, fn):
    try:
        out[name] = {"ok": True, "value": fn()}
    except Exception:
        out[name] = {"ok": False, "error": traceback.format_exc()[-3000:]}

small = lambda name, seq, batch: dataclasses.replace(
    SHAPES[name], seq_len=seq, global_batch=batch)
SHAPE = {"train": small("train_4k", 64, 8),
         "prefill": small("prefill_32k", 64, 8)}
sp = AxisRules()
for logical, axes in SP:
    sp = sp.replacing(logical, axes)
dryrun.ensure_fake_world(8)
mesh = make_mesh((4, 2), ("data", "model"))

def plan(arch, kind, rules):
    rec = dryrun.plan_cell(reduced(get_config(arch), num_layers=2),
                           SHAPE[kind], mesh, rules)
    r = rec["roofline"]
    return {"flops": r["flops_per_device"], "peak": r["peak_mem_bytes"],
            "coll": r["coll_by_kind"]}

for arch, kind in (("yi_9b", "prefill"), ("llama3_2_1b", "train")):
    case(f"{arch}/{kind}/default", lambda: plan(arch, kind, AxisRules()))
for arch in ARCH_IDS:
    for kind in ("train", "prefill"):
        case(f"{arch}/{kind}/sp", lambda: plan(arch, kind, sp))
print(json.dumps(out))
"""

JAX_PLANS = """
import dataclasses, json, os
import jax, numpy as np
from jax.sharding import Mesh
from repro.configs import get_config
from repro.configs.base import ParallelConfig, SHAPES, reduced
from repro.launch.dryrun import build_lowerable
from repro.parallel.sharding import AxisRules
from repro.roofline.hlo_cost import HloCostModel
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
small = lambda name, seq, batch: dataclasses.replace(
    SHAPES[name], seq_len=seq, global_batch=batch)
rules = AxisRules()
for logical, axes in SP:
    rules = rules.replacing(logical, axes)
mesh = Mesh(np.array(jax.devices()[:8]).reshape(4, 2), ("data", "model"))
out = {}
for arch, kind, name in (("yi_9b", "prefill", "prefill_32k"),
                         ("llama3_2_1b", "train", "train_4k")):
    jitted, args = build_lowerable(reduced(get_config(arch), num_layers=2),
                                   small(name, 64, 8), mesh, rules,
                                   ParallelConfig())
    with mesh:
        compiled = jitted.lower(*args).compile()
    out[f"{arch}/{kind}"] = HloCostModel(compiled.as_text()).cost().flops
print(json.dumps(out))
"""


def _run_plans(code: str, env: dict) -> dict:
    import os
    import subprocess
    import sys
    import textwrap
    from _torch_dist import SRC
    env = {**os.environ, "PYTHONPATH": str(SRC), "JAX_PLATFORMS": "cpu",
           "OMP_NUM_THREADS": "1", "PYTHONWARNINGS": "ignore", **env}
    res = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         capture_output=True, text=True, timeout=600, env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def sp_plans():
    """The port's plans at (4, 2) (one torch process over a fake 8-rank
    group) and the JAX dry-run's FLOPs under the SP rules (8 host
    devices)."""
    head = f"SP = {SP!r}\n"
    port = _run_plans(head + PLANS, {})
    ref = _run_plans(head + JAX_PLANS, {
        "XLA_FLAGS": "--xla_force_host_platform_device_count=8"})
    return port, ref


def _plan(port, name):
    got = port[name]
    assert got["ok"], got["error"]
    return got["value"]


@pytest.mark.parametrize("cell", ["yi_9b/prefill", "llama3_2_1b/train"])
def test_sequence_parallel_plan_matches_the_jax_dry_run(cell, sp_plans):
    """A rank's FLOPs within FLOPS_RTOL of the JAX dry-run's under the SP
    rules (the reference splits the sequence, the port the heads: the
    same work a rank); the residual's slices and the saved layer inputs
    at 1/M lower the planned peak below the default rules'."""
    port, ref = sp_plans
    sp = _plan(port, f"{cell}/sp")
    default = _plan(port, f"{cell}/default")
    assert sp["flops"] == pytest.approx(ref[cell], rel=FLOPS_RTOL)
    assert sp["peak"] < default["peak"], (sp["peak"], default["peak"])
    # the sequence collectives: all-gathers in, reduce-scatters out
    assert sp["coll"].get("reduce-scatter", 0) > 0


@pytest.mark.parametrize("kind", ["train", "prefill"])
@pytest.mark.parametrize("arch", sorted(ARCH_IDS))
def test_every_config_plans_under_sequence_parallelism(sp_plans, arch, kind):
    got = _plan(sp_plans[0], f"{arch}/{kind}/sp")
    assert got["flops"] > 0 and got["peak"] > 0


# -- four cards -------------------------------------------------------------------
@pytest.mark.gpu
def test_four_cards_train_sequence_parallel_as_one_card(tmp_path):
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    spawn(f"""
        from repro_torch.configs import get_config
        from repro_torch.configs.base import (ParallelConfig, TrainConfig,
                                              reduced)
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.models import transformer
        from repro_torch.models.common import (tree_leaves, tree_map,
                                               tree_unflatten)
        from repro_torch.models.model import build_model
        from repro_torch.parallel.sharding import AxisRules
        from repro_torch.train import steps
        model = build_model(reduced(get_config("llama3_2_1b"),
                                    dtype="float32"))
        drawn = model.init(torch.Generator(device=device).manual_seed(0),
                           device=device)
        # in fp32, the stacked leaves at 1/sqrt(fan-in), as
        # tests/test_torch_parallel.py's four-card case takes them
        init = tree_unflatten(drawn, [
            t.float() * float(np.sqrt(s.shape[0] / s.shape[1]))
            if s.init == "scaled" and s.logical[0] == "layers"
            else t.float()
            for s, t in zip(tree_leaves(model.specs), tree_leaves(drawn))])
        rng = np.random.default_rng(10)
        batches = [{{k: torch.from_numpy(rng.integers(
            0, model.cfg.vocab_size, (8, 32))).to(device)
            for k in ("tokens", "labels")}} for _ in range(3)]
        tcfg = TrainConfig(**{STEP_CFG!r})
        rules = AxisRules().replacing("seq", "model")
        lengths = []
        layer = transformer.layer_forward
        def recorded(lp, x, *a, **k):
            lengths.append(x.shape[1])
            return layer(lp, x, *a, **k)
        transformer.layer_forward = recorded
        mesh = make_mesh((1, 4), ("data", "model"))
        runs = []
        for sharded in (False, True):
            params = tree_map(lambda t: t.clone(), init)
            state = steps.TrainState(params, steps.adamw_init(params))
            if sharded:
                state = steps.shard_train_state(
                    state, steps.train_state_shardings(model, mesh, rules))
                step = steps.make_sharded_train_step(
                    model, ParallelConfig(), tcfg, mesh, rules)
            else:
                step = steps.make_train_step(model, ParallelConfig(), tcfg)
            lengths.clear()
            metrics = []
            for batch in batches:
                state, m = step(state, batch)
                metrics.append({{k: float(v) for k, v in m.items()}})
            runs.append((metrics, tree_leaves(
                steps.gather_state(state.params)), sorted(set(lengths))))
        assert runs[0][2] == [32] and runs[1][2] == [8], runs
        for got, want in zip(runs[1][0], runs[0][0]):
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                           atol=1e-8, err_msg=k)
        for a, b in zip(runs[1][1], runs[0][1]):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)
    """, world=4, tmp_path=tmp_path, backend="nccl")
