"""int8 AdamW state in the sharded train step, on 4 gloo ranks on the CPU
(tests/_torch_dist.py).

The int8 moments are blockwise over the flattened whole leaf (blocks of
256, ``optim.quant``), as in the unsharded step, which
tests/test_torch_optim.py holds to the JAX package; over a mesh they are
laid out by ``quant.block_layout`` so that a rank's blocks are the
leaf's (reduced Llama over (1, 4) runs all three layouts: shards of whole
blocks, blocks moved to an outer dim, chunks of a few-block leaf).

- Given the same gradients, the sharded update (``steps.int8_adamw``) of
  a state after 3 unsharded int8 steps equals ``adamw_update`` on the
  whole state bit for bit, params and moments, over (4, 1), (2, 2) and
  (1, 4); a rank holds at most its share of each cut leaf's blocks
  (rounded up to a whole block) and their scales; a state drawn shard
  by shard (``steps.init_sharded_train_state``) is the whole draw's.
- The sharded int8 step over (4, 1) and (2, 2) against the unsharded int8
  step on the same params and batches: the metrics of 3 steps at rtol
  1e-5; the params after them at rtol 1e-4, atol 1e-6 but on at most 1%
  of the elements, none further than 2e-3: the gradients differ in their
  order of sums, and a moment near a rounding boundary of its block then
  lands on the next int8 level (a step of lr = 1e-3 moves an element at
  most about lr).  Over a one-rank mesh the step is the unsharded one,
  bit for bit.
- A sharded checkpoint of int8 state round-trips: restored onto its mesh
  bit for bit, onto another mesh (another layout) and unsharded to the
  same moments.
- ``launch.train --opt-dtype int8`` under gloo ``torchrun`` over (2, 2)
  runs, checkpoints and restores.
- The dry-run plans the int8 train cell at (4, 2) and counts its state's
  bytes: a rank's moments under 0.3 of its fp32 moments.
- ``gpu`` (``pytest --noconftest -m gpu``, four cards, no JAX): NCCL over
  (2, 2) trains 3 int8 steps of reduced Llama as the unsharded int8 step
  does on each card, at the tolerances above.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_dist import SRC, spawn  # noqa: E402

STEP_CFG = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10)

COMMON = f"""
import copy, json
from repro_torch.configs import get_config
from repro_torch.configs.base import ParallelConfig, TrainConfig, reduced
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.common import tree_leaves, tree_map, tree_unflatten
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import adamw_init, adamw_update
from repro_torch.optim.quant import (LogQTensor, QTensor, block_layout,
                                     dequantize, dequantize_log)
from repro_torch.train import steps
INT8 = ParallelConfig(opt_state_dtype="int8")
tcfg = TrainConfig(**{STEP_CFG!r})
model = build_model(reduced(get_config("llama3_2_1b"), dtype="float32"))
drawn = model.init(torch.Generator().manual_seed(0), device="cpu")
# in fp32, the stacked leaves at 1/sqrt(fan-in) (tests/test_torch_train.py)
init = tree_unflatten(drawn, [
    t.float() * float(np.sqrt(s.shape[0] / s.shape[1]))
    if s.init == "scaled" and s.logical[0] == "layers" else t.float()
    for s, t in zip(tree_leaves(model.specs), tree_leaves(drawn))])
rng = np.random.default_rng(10)
batches = [{{k: torch.from_numpy(rng.integers(
    0, model.cfg.vocab_size, (8, 16))) for k in ("tokens", "labels")}}
    for _ in range(3)]
is_q = lambda x: isinstance(x, (QTensor, LogQTensor))

def fresh():
    params = tree_map(lambda t: t.clone(), init)
    return steps.TrainState(params, adamw_init(params, "int8"))

def run(state, step):
    metrics = []
    for batch in batches:
        state, m = step(state, batch)
        metrics.append({{k: float(v) for k, v in m.items()}})
    return state, metrics

def moments(opt):
    return [dequantize(q) if isinstance(q, QTensor) else dequantize_log(q)
            for q in tree_leaves((opt.m, opt.v), is_leaf=is_q)]

def whole(state):
    return steps.gather_state(state)
"""


@pytest.fixture(scope="module")
def int8_runs(tmp_path_factory):
    """The checks of the update, the step and the checkpoint over 4 ranks;
    returns what the ranks wrote."""
    tmp = tmp_path_factory.mktemp("int8")
    out = spawn(COMMON + textwrap.dedent("""
        from repro_torch.checkpoint.checkpoint import CheckpointManager
        from repro_torch.parallel.sharding import local_slice
        from torch.distributed.tensor import Shard
        report = {"kinds": set(), "steps": {}}
        # the state after 3 unsharded int8 steps, and a gradient
        base, _ = run(fresh(), steps.make_train_step(model, INT8, tcfg))
        grng = np.random.default_rng(3)
        grads = [torch.from_numpy(grng.normal(size=p.shape).astype(
            np.float32)) for p in tree_leaves(base.params)]
        gnorm = torch.sqrt(sum(g.square().sum() for g in grads))
        lr = torch.tensor(1e-3)
        want = copy.deepcopy(base)
        _, opt, _ = adamw_update(tree_unflatten(want.params, grads),
                                 want.opt_state, want.params, lr, tcfg,
                                 state_dtype="int8", gnorm=gnorm)
        want = steps.TrainState(want.params, opt)
        for shape in ((4, 1), (2, 2), (1, 4)):
            mesh = make_mesh(shape, ("data", "model"))
            sh = steps.train_state_shardings(model, mesh,
                                             opt_state_dtype="int8")
            state = steps.shard_train_state(copy.deepcopy(base), sh)
            local = [local_slice(g, mesh, p.placements) for g, p in
                     zip(grads, tree_leaves(state.params))]
            steps.int8_adamw(local, state, lr, tcfg, gnorm)
            got = whole(state)
            for a, b in zip(tree_leaves(got.params), tree_leaves(want.params)):
                assert torch.equal(a, b), shape
            for a, b in zip(moments(got.opt_state), moments(want.opt_state)):
                assert torch.equal(a, b), shape
            # a state drawn shard by shard: the whole draw's, zero moments
            drawn = whole(steps.init_sharded_train_state(
                model, torch.Generator().manual_seed(1), INT8, mesh))
            plain = steps.init_train_state(
                model, torch.Generator().manual_seed(1), INT8, device="cpu")
            for a, b in zip(tree_leaves(drawn.params),
                            tree_leaves(plain.params)):
                assert torch.equal(a, b), shape
            for a, b in zip(moments(drawn.opt_state),
                            moments(plain.opt_state)):
                assert torch.equal(a, b), shape
            # a rank's blocks of each cut leaf: its share, rounded up
            for p, q in zip(tree_leaves(state.params), tree_leaves(
                    (state.opt_state.m, state.opt_state.v), is_leaf=is_q)):
                lay = block_layout(p.shape, mesh, p.placements)
                report["kinds"].add("chunks" if lay.cut is None else
                                    "shards" if lay.cut == tuple(p.placements)
                                    else "moved")
                ranks = int(np.prod([n for n, pl in zip(mesh.shape,
                                                        p.placements)
                                     if isinstance(pl, Shard)]))
                blocks = -(-p.numel() // 256)
                share = -(-blocks // ranks)
                data = q.data.to_local()
                assert data.numel() <= share * 256, (shape, p.shape)
                for t in q.tree_flatten()[0][1:]:
                    assert t.to_local().numel() <= share
        report["kinds"] = sorted(report["kinds"])

        # the sharded int8 step against the unsharded int8 step
        ref_state, ref_metrics = run(fresh(), steps.make_train_step(
            model, INT8, tcfg))
        ref = [t for t in tree_leaves(ref_state.params)]
        for shape in ((4, 1), (2, 2)):
            mesh = make_mesh(shape, ("data", "model"))
            sh = steps.train_state_shardings(model, mesh,
                                             opt_state_dtype="int8")
            state, metrics = run(steps.shard_train_state(fresh(), sh),
                                 steps.make_sharded_train_step(
                                     model, INT8, tcfg, mesh))
            for got, w in zip(metrics, ref_metrics):
                for k in w:
                    np.testing.assert_allclose(got[k], w[k], rtol=1e-5,
                                               atol=1e-8, err_msg=k)
            got = tree_leaves(whole(state.params))
            far = max(float((a - b).abs().max()) for a, b in zip(got, ref))
            off = sum(int((~torch.isclose(a, b, rtol=1e-4, atol=1e-6)).sum())
                      for a, b in zip(got, ref))
            report["steps"][f"{shape[0]}x{shape[1]}"] = {
                "far": far, "off": off,
                "total": sum(t.numel() for t in ref)}

            if shape == (2, 2):
                # a checkpoint of the sharded int8 state
                ckpt = CheckpointManager(out / "ckpt")
                ckpt.save(3, state, blocking=True)
                dist.barrier()
                back, step = ckpt.restore(steps.shard_train_state(
                    fresh(), sh), shardings=sh)
                assert step == 3
                for a, b in zip(tree_leaves(whole(back)),
                                tree_leaves(whole(state))):
                    assert torch.equal(a, b)
                other = make_mesh((4, 1), ("data", "model"))
                osh = steps.train_state_shardings(model, other,
                                                  opt_state_dtype="int8")
                moved, _ = ckpt.restore(steps.shard_train_state(fresh(), osh),
                                        shardings=osh)
                plain, _ = ckpt.restore(fresh())
                saved = whole(state)
                for got in (whole(moved), plain):
                    for a, b in zip(tree_leaves(got.params),
                                    tree_leaves(saved.params)):
                        assert torch.equal(a, b)
                    for a, b in zip(moments(got.opt_state),
                                    moments(saved.opt_state)):
                        assert torch.equal(a, b)
        if rank == 0:
            (out / "report.json").write_text(json.dumps(report))
    """), world=4, tmp_path=tmp, timeout=600)
    # one rank: the unsharded step, bit for bit
    one = tmp / "one"
    spawn(COMMON + textwrap.dedent("""
        mesh = make_mesh((1, 1), ("data", "model"))
        sh = steps.train_state_shardings(model, mesh, opt_state_dtype="int8")
        state, metrics = run(steps.shard_train_state(fresh(), sh),
                             steps.make_sharded_train_step(model, INT8, tcfg,
                                                           mesh))
        ref, ref_metrics = run(fresh(), steps.make_train_step(model, INT8,
                                                              tcfg))
        assert metrics == ref_metrics
        got = whole(state)
        for a, b in zip(tree_leaves(got.params), tree_leaves(ref.params)):
            assert torch.equal(a, b)
        for a, b in zip(moments(got.opt_state), moments(ref.opt_state)):
            assert torch.equal(a, b)
        (out / "one.json").write_text(json.dumps(metrics))
    """), world=1, tmp_path=one, timeout=300)
    return json.loads((out / "report.json").read_text())


def test_sharded_update_is_the_whole_update(int8_runs):
    """Checked on the ranks; here: the cases ran every layout."""
    assert int8_runs["kinds"] == ["chunks", "moved", "shards"]


@pytest.mark.parametrize("mesh", ["4x1", "2x2"])
def test_sharded_int8_step_matches_the_unsharded_step(int8_runs, mesh):
    got = int8_runs["steps"][mesh]
    assert got["off"] <= 0.01 * got["total"], got
    assert got["far"] <= 2e-3, got


def test_launch_train_int8_under_torchrun(tmp_path):
    ck = tmp_path / "ck"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "4", "-m", "repro_torch.launch.train",
           "--preset", "smoke", "--device", "cpu", "--batch", "8", "--seq",
           "32", "--opt-dtype", "int8", "--model-parallel", "2",
           "--ckpt-dir", str(ck), "--ckpt-every", "3", "--log-every", "1"]
    env = {**os.environ, "PYTHONPATH": str(SRC), "OMP_NUM_THREADS": "1",
           "PYTHONWARNINGS": "ignore"}
    for steps in (3, 5):
        res = subprocess.run(cmd + ["--steps", str(steps)], env=env,
                             capture_output=True, text=True, timeout=300)
        assert res.returncode == 0, res.stderr[-3000:]
        assert "final loss" in res.stdout, res.stdout[-2000:]
    assert "restored step 3" in res.stdout, res.stdout[-2000:]


def test_dryrun_counts_int8_state_bytes():
    code = """
import dataclasses, json
from repro_torch.configs import get_config
from repro_torch.configs.base import ParallelConfig, SHAPES, reduced
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
dryrun.ensure_fake_world(8)
mesh = make_mesh((4, 2), ("data", "model"))
shape = dataclasses.replace(SHAPES["train_4k"], seq_len=64, global_batch=8)
cfg = reduced(get_config("llama3_2_1b"), num_layers=2)
out = {d: dryrun.plan_cell(cfg, shape, mesh, pcfg=ParallelConfig(
    opt_state_dtype=d))["resident_bytes"] for d in ("float32", "int8")}
print(json.dumps(out))
"""
    env = {**os.environ, "PYTHONPATH": str(SRC), "OMP_NUM_THREADS": "1",
           "PYTHONWARNINGS": "ignore"}
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got["int8"]["params"] == got["float32"]["params"]
    assert 0 < got["int8"]["opt_state"] < 0.3 * got["float32"]["opt_state"]


@pytest.mark.gpu
def test_four_cards_train_int8_state_as_one_card(tmp_path):
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    on_card = COMMON.replace('device="cpu"', "device=device").replace(
        "torch.Generator()", "torch.Generator(device=device)")
    spawn(on_card + textwrap.dedent("""
        batches = [{k: v.to(device) for k, v in b.items()} for b in batches]
        mesh = make_mesh((2, 2), ("data", "model"))
        sh = steps.train_state_shardings(model, mesh, opt_state_dtype="int8")
        state, metrics = run(steps.shard_train_state(fresh(), sh),
                             steps.make_sharded_train_step(model, INT8, tcfg,
                                                           mesh))
        ref, ref_metrics = run(fresh(), steps.make_train_step(model, INT8,
                                                              tcfg))
        for got, w in zip(metrics, ref_metrics):
            for k in w:
                np.testing.assert_allclose(got[k], w[k], rtol=1e-5,
                                           atol=1e-8, err_msg=k)
        got = tree_leaves(whole(state.params))
        want = tree_leaves(ref.params)
        off = sum(int((~torch.isclose(a, b, rtol=1e-4, atol=1e-6)).sum())
                  for a, b in zip(got, want))
        assert off <= 0.01 * sum(t.numel() for t in want), off
        assert max(float((a - b).abs().max())
                   for a, b in zip(got, want)) <= 2e-3
    """), world=4, tmp_path=tmp_path, backend="nccl")
