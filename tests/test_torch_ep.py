"""Expert parallelism and MLA's heads over the ``model`` axis, against the
JAX package, on 4 gloo ranks on the CPU (tests/_torch_dist.py).

- The sharded train step on ``reduced(deepseek_v3_671b)`` (a dense MLA
  layer, then an MoE layer with the sigmoid router, its aux-free bias
  and a shared expert; the MTP module) over a (2, 2) data x model mesh,
  both reduced models over (1, 4), both over (2, 2) under the EP-2D
  rules (``launch.autotune.EP2D``: the experts over ``("model",
  "data")``, the dispatch buffer exchanged by an all-to-all over the
  data axis), and the reduced Mixtral at 2 experts over (1, 4), where
  the experts do not divide the axis and each expert's FFN columns split
  instead (``expert_mlp``): the metrics of 3 steps at rtol 1e-5 (grad
  norm included) and the params after them at rtol 1e-4, atol 1e-6
  against the JAX package's jitted ``make_train_step`` on one device,
  from the same carried-over params (the tolerances and batches of
  tests/test_torch_parallel.py, whose (4, 1) and (2, 2) Mixtral cases
  run expert-parallel too).  The EP-2D cases run the all-to-all, the
  others do not.  At (1, 4) a rank holds a quarter of each expert leaf
  (or of its FFN columns) and of MLA's ``wq_b``, ``wk_b``, ``wv_b`` and
  ``wo``.
- Both reduced models served greedily in fp32 over (1, 2) and (1, 4)
  pilot meshes of gloo ranks give exactly the tokens of the JAX engine
  over its (1, 2) pilot mesh on 2 host devices, on the same carried-over
  weights and prompts (a prefill wave, then refills).
"""
import dataclasses
import json
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_dist import run_jax, spawn  # noqa: E402

STEP_CFG = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10)
# (model, mesh, rules); "mixtral_8x22b:e2" is the reduced Mixtral at 2
# experts, which a model axis of 4 does not divide
CASES = [("deepseek_v3_671b", (2, 2), "default"),
         ("mixtral_8x22b", (1, 4), "default"),
         ("deepseek_v3_671b", (1, 4), "default"),
         ("mixtral_8x22b", (2, 2), "ep2d"),
         ("deepseek_v3_671b", (2, 2), "ep2d"),
         ("mixtral_8x22b:e2", (1, 4), "default")]
# MoE fields set on both packages' reduced configs.  ``reduced`` keeps
# DeepSeek-V3's published 18432-wide dense FFN (its first layer's and the
# MTP layer's); there even the unsharded port step misses the JAX step's
# params at these tolerances, on 1 of 1,179,648 elements of the MTP
# layer's ``w_down`` (2.2e-6: AdamW's first update of a near-zero
# gradient is about its sign, which the order of a float32 sum decides;
# in float64 the two steps agree to 2e-15, tests/_dense_width_probe.py),
# so it is cut to the reduced width of every other FFN here
MOE = {"mixtral_8x22b:e2": {"num_experts": 2},
       "deepseek_v3_671b": {"first_dense_d_ff": 128}}


def _case_name(name, shape, rules):
    return f"{name.replace(':', '-')}-{shape[0]}x{shape[1]}-{rules}"


def _models(name):
    """(JAX model, port model, the JAX init in fp32 as numpy, the stacked
    leaves rescaled as tests/test_torch_train.py takes them)."""
    import jax
    from repro.configs import get_config as ref_get_config
    from repro.configs.base import reduced as ref_reduced
    from repro.models.common import ParamSpec as RefParamSpec
    from repro.models.model import build_model as ref_build_model
    from repro_torch.configs import get_config
    from repro_torch.configs.base import reduced
    from repro_torch.models.model import build_model
    from test_torch_train import _fan_in_scale

    arch = name.split(":")[0]
    rcfg = ref_reduced(ref_get_config(arch), dtype="float32")
    pcfg = reduced(get_config(arch), dtype="float32")
    if name in MOE:
        rcfg = dataclasses.replace(rcfg, moe=dataclasses.replace(
            rcfg.moe, **MOE[name]))
        pcfg = dataclasses.replace(pcfg, moe=dataclasses.replace(
            pcfg.moe, **MOE[name]))
    ref = ref_build_model(rcfg)
    params = jax.tree.map(
        lambda spec, leaf: np.asarray(leaf, np.float32)
        * np.float32(_fan_in_scale(spec)),
        ref.specs, ref.init(jax.random.key(0)),
        is_leaf=lambda x: isinstance(x, RefParamSpec))
    return ref, build_model(pcfg), params


@pytest.fixture(scope="module")
def ep_steps(tmp_path_factory):
    """The JAX step's metrics and params for each model, and the port's
    from 4 ranks for every case, with the all-to-all calls each case made
    and, at (1, 4), the shapes of a rank's expert and MLA leaves."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import ParallelConfig as RefParallelConfig
    from repro.configs.base import TrainConfig as RefTrainConfig
    from repro.optim.adamw import adamw_init as ref_adamw_init
    from repro.train import steps as ref_steps
    from test_torch_train import _batch

    tmp = tmp_path_factory.mktemp("ep")
    inputs, want = {}, {}
    for name in sorted({c[0] for c in CASES}):
        ref, port, params = _models(name)
        batches = [_batch(port.cfg, b=4, s=16, seed=10 + i)
                   for i in range(3)]
        inputs[name] = (params, batches, port.cfg)
        step = jax.jit(ref_steps.make_train_step(
            ref, RefParallelConfig(), RefTrainConfig(**STEP_CFG)))
        jp = jax.tree.map(jnp.asarray, params)
        state = ref_steps.TrainState(jp, ref_adamw_init(jp))
        metrics = []
        for batch in batches:
            state, m = step(state, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
            metrics.append({k: float(v) for k, v in m.items()})
        want[name] = (metrics, [np.asarray(x) for x in
                                jax.tree.leaves(state.params)])
    (tmp / "inputs.pkl").write_bytes(pickle.dumps(inputs))
    spawn(f"""
        import json, pickle
        from repro_torch.carry import params_from_numpy
        from repro_torch.configs.base import ParallelConfig, TrainConfig
        from repro_torch.launch.autotune import EP2D
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.models import moe
        from repro_torch.models.common import tree_leaves
        from repro_torch.models.model import build_model
        from repro_torch.optim.adamw import adamw_init
        from repro_torch.parallel.sharding import AxisRules
        from repro_torch.serving.engine import flatten_params
        from repro_torch.train import steps
        inputs = pickle.loads(Path({str(tmp / "inputs.pkl")!r}).read_bytes())
        tcfg = TrainConfig(**{STEP_CFG!r})
        calls = [0]
        exchange = moe.all_to_all
        def counted(x, group):
            calls[0] += 1
            return exchange(x, group)
        moe.all_to_all = counted
        for name, shape, which in {CASES!r}:
            params, batches, cfg = inputs[name]
            model = build_model(cfg)
            rules = AxisRules()
            if which == "ep2d":
                for logical, axes in EP2D:
                    rules = rules.replacing(logical, axes)
            mesh = make_mesh(shape, ("data", "model"))
            # the state drawn shard by shard is the whole draw's shards
            drawn = steps.init_sharded_train_state(
                model, torch.Generator().manual_seed(0), ParallelConfig(),
                mesh, rules)
            whole = steps.shard_train_state(
                steps.init_train_state(model, torch.Generator().manual_seed(0),
                                       ParallelConfig(), device="cpu"),
                steps.train_state_shardings(model, mesh, rules))
            same_draw = all(
                torch.equal(a.to_local(), b.to_local())
                and a.placements == b.placements
                for a, b in zip(tree_leaves(drawn), tree_leaves(whole))
                if hasattr(a, "to_local"))
            del drawn, whole
            params = params_from_numpy(params, "cpu")
            state = steps.shard_train_state(
                steps.TrainState(params, adamw_init(params)),
                steps.train_state_shardings(model, mesh, rules))
            step = steps.make_sharded_train_step(model, ParallelConfig(),
                                                 tcfg, mesh, rules)
            calls[0] = 0
            metrics = []
            for batch in batches:
                state, m = step(state, {{k: torch.from_numpy(v)
                                        for k, v in batch.items()}})
                metrics.append({{k: float(v) for k, v in m.items()}})
            local = {{"/".join(p): list(t.to_local().shape)
                     for p, t in flatten_params(state.params)
                     if p[-1] in ("w_gate", "w_down", "wq_b", "wk_b",
                                  "wv_b", "wo") and "layers" in p[0]}}
            leaves = [t.numpy() for t in
                      tree_leaves(steps.gather_state(state.params))]
            if rank == 0:
                tag = "-".join((name.replace(":", "-"),
                                f"{{shape[0]}}x{{shape[1]}}", which))
                np.savez(out / f"{{tag}}.npz", *leaves)
                (out / f"{{tag}}.json").write_text(json.dumps(
                    {{"metrics": metrics, "all_to_all": calls[0],
                     "local": local, "same_draw": same_draw}}))
    """, world=4, tmp_path=tmp, timeout=240)
    return want, tmp / "dist_out"


@pytest.mark.parametrize("case", CASES, ids=[_case_name(*c) for c in CASES])
def test_expert_parallel_step_matches_the_reference(case, ep_steps):
    name, shape, which = case
    want, out = ep_steps
    want_metrics, want_params = want[name]
    tag = _case_name(*case)
    got = json.loads((out / f"{tag}.json").read_text())
    for g, ref in zip(got["metrics"], want_metrics):
        assert sorted(g) == sorted(ref)
        for k in ref:
            np.testing.assert_allclose(g[k], ref[k], rtol=1e-5, atol=1e-8,
                                       err_msg=k)
    z = np.load(out / f"{tag}.npz")
    got_params = [z[f"arr_{i}"] for i in range(len(z.files))]
    assert len(got_params) == len(want_params)
    for g, w in zip(got_params, want_params):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6)
    # EP-2D exchanges the dispatch buffer (there and back, a MoE layer
    # and a step); the default rules keep every token on its data rank
    assert (got["all_to_all"] > 0) == (which == "ep2d"), got["all_to_all"]


def test_a_rank_holds_a_quarter_of_the_experts_and_mla_heads(ep_steps):
    """At (1, 4) a rank holds E/4 experts (or, at 2 experts, each
    expert's d_ff/4 columns) and H/4 of MLA's heads."""
    _, out = ep_steps
    local = lambda tag: json.loads(
        (out / f"{tag}-1x4-default.json").read_text())["local"]
    mix = local("mixtral_8x22b")
    assert mix["layers/moe/w_gate"] == [2, 1, 64, 64]       # 4 experts
    assert mix["layers/moe/w_down"] == [2, 1, 64, 64]
    two = local("mixtral_8x22b-e2")
    assert two["layers/moe/w_gate"] == [2, 2, 64, 16]       # d_ff 64
    assert two["layers/moe/w_down"] == [2, 2, 16, 64]
    ds = local("deepseek_v3_671b")
    assert ds["layers/moe/w_gate"] == [1, 1, 64, 64]
    for stack in ("layers", "layers_dense"):                # 4 heads
        assert ds[f"{stack}/attn/wq_b"] == [1, 32, 1, 24]
        assert ds[f"{stack}/attn/wk_b"] == [1, 16, 1, 16]
        assert ds[f"{stack}/attn/wv_b"] == [1, 16, 1, 16]
        assert ds[f"{stack}/attn/wo"] == [1, 1, 16, 64]


def test_a_sharded_state_is_drawn_shard_by_shard(ep_steps):
    """``steps.init_sharded_train_state`` (each rank draws only its blocks)
    gives every rank the shards of ``init_train_state``'s whole draw, on
    every case's mesh and rules."""
    _, out = ep_steps
    for case in CASES:
        got = json.loads((out / f"{_case_name(*case)}.json").read_text())
        assert got["same_draw"], case


def test_ep2d_placements_deal_the_experts_in_mesh_order():
    """EP-2D's ``("model", "data")`` on a data x model mesh: refused by
    ``placements``, whose nesting must be the mesh's, and placed in the
    mesh's order by way of ``mesh_ordered`` (as ``named_sharding`` and
    ``model_placements`` place every leaf)."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.launch.autotune import EP2D
    from repro_torch.launch.mesh import make_abstract_mesh
    from repro_torch.parallel.sharding import (AxisRules, PartitionSpec,
                                               mesh_ordered, placements,
                                               resolve_pspec)
    mesh = make_abstract_mesh((2, 2), ("data", "model"))
    rules = AxisRules()
    for logical, axes in EP2D:
        rules = rules.replacing(logical, axes)
    spec = resolve_pspec(("layers", "expert", "expert_embed", "expert_mlp"),
                         (2, 8, 16, 32), mesh, rules)
    assert spec == PartitionSpec(None, ("model", "data"))
    with pytest.raises(NotImplementedError, match="order"):
        placements(spec, mesh)
    assert mesh_ordered(spec, mesh) == PartitionSpec(None,
                                                     ("data", "model"))
    assert placements(mesh_ordered(spec, mesh), mesh) == [Shard(1),
                                                          Shard(1)]
    assert placements(mesh_ordered(PartitionSpec(None, "model"), mesh),
                      mesh) == [Replicate(), Shard(1)]


class _Rank:
    """A rank of a data x model mesh as the layout functions read it (its
    axes, sizes and coordinate), without a process group."""

    def __init__(self, shape, coord):
        self.mesh_dim_names = ("data", "model")
        self.shape = tuple(shape)
        self.coord = list(coord)

    def size(self, dim=None):
        return self.shape[dim] if dim is not None else int(
            np.prod(self.shape))

    def get_coordinate(self):
        return self.coord

    def get_local_rank(self, name):
        return self.coord[self.mesh_dim_names.index(name)]


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)], ids=["1x4", "2x2"])
@pytest.mark.parametrize("arch", ["mixtral_8x22b", "deepseek_v3_671b",
                                  "hymba_1_5b"])
def test_a_rank_draws_only_its_blocks(arch, shape, monkeypatch):
    """``transformer.local_draw`` (what the serving engine draws over a
    pilot mesh) gives each rank's leaf of the whole seeded draw, by its
    layout (the SSM's paired ``w_in`` on Hymba), and draws only the
    blocks it holds: at (1, 4) a quarter of a stacked expert leaf's."""
    import itertools

    from repro_torch.configs import get_config
    from repro_torch.configs.base import reduced
    from repro_torch.models import common
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import (local_draw, local_leaf,
                                                tp_layouts)
    from repro_torch.parallel.sharding import AxisRules
    from repro_torch.serving.engine import flatten_params

    cfg = reduced(get_config(arch))
    model = build_model(cfg)
    whole = flatten_params(model.init(torch.Generator().manual_seed(1),
                                      device="cpu"))
    specs = [s for _, s in flatten_params(model.specs)]
    lays = [lay for _, lay in flatten_params(tp_layouts(model.specs, cfg))]
    blocks = []
    draw = common._draw_block
    monkeypatch.setattr(common, "_draw_block",
                        lambda *a: blocks.append(a[0]) or draw(*a))
    cpu = torch.device("cpu")
    for coord in itertools.product(*map(range, shape)):
        rank = _Rank(shape, coord)
        gen = torch.Generator().manual_seed(1)
        for spec, lay, (path, w) in zip(specs, lays, whole):
            blocks.clear()
            got = local_draw(spec, common.leaf_seed(gen), lay, rank,
                             AxisRules(), cpu)
            want = local_leaf(w, spec, lay, rank, AxisRules())
            assert torch.equal(got, want), path
            if path[-1] == "w_gate" and "moe" in path and shape == (1, 4):
                assert len(blocks) == w.shape[0] * w.shape[1] // 4, path


# -- serving over a pilot mesh -----------------------------------------------
SERVED = ("mixtral_8x22b", "deepseek_v3_671b")
LENS = (6, 6, 9, 7, 6)
GEN, MAX_LEN, BATCH = 6, 32, 2


@pytest.fixture(scope="module")
def jax_served(tmp_path_factory):
    """The JAX engine's tokens over its (1, 2) pilot mesh for each model,
    and the params and prompts it served."""
    tmp = tmp_path_factory.mktemp("ep_serve")
    run_jax(f"""
        import json, pickle
        import jax, jax.numpy as jnp, numpy as np
        import repro.core as core
        from repro.configs import get_config
        from repro.configs.base import reduced
        from repro.models.model import build_model
        from repro.serving import ServingEngine
        rng = np.random.default_rng(5)
        prompts = [rng.integers(0, 256, size=n).astype(np.int32)
                   for n in {LENS!r}]
        tokens, params = {{}}, {{}}
        for arch in {SERVED!r}:
            model = build_model(reduced(get_config(arch), dtype="float32"))
            p = jax.tree.map(lambda x: x.astype(jnp.float32),
                             model.init(jax.random.key(0)))
            with core.PilotSession() as s:
                s.add_pilots(1, num_devices=2, mesh_axes=("data", "model"),
                             mesh_shape=(1, 2), memory_gb=0.25)
                with ServingEngine(s, model, params=p, batch_size={BATCH},
                                   max_len={MAX_LEN}, page_tokens=4) as eng:
                    eng.deploy()
                    reqs = [eng.submit(q, {GEN}) for q in prompts]
                    eng.drain(timeout=120)
                    tokens[arch] = [r.result(timeout=5) for r in reqs]
            params[arch] = jax.tree.map(np.asarray, p)
        open({str(tmp / "jax.json")!r}, "w").write(json.dumps(tokens))
        open({str(tmp / "params.pkl")!r}, "wb").write(
            pickle.dumps((params, prompts)))
    """, devices=2, timeout=240)
    return json.loads((tmp / "jax.json").read_text()), tmp / "params.pkl"


@pytest.fixture(scope="module", params=[(1, 2), (1, 4)], ids=["1x2", "1x4"])
def port_served(request, jax_served, tmp_path_factory):
    """Every rank's tokens for each model over the pilot mesh."""
    mesh = request.param
    tmp = tmp_path_factory.mktemp(f"ep_serve_{mesh[0]}x{mesh[1]}")
    out = spawn(f"""
        import json, pickle
        from repro_torch.carry import params_from_numpy
        from repro_torch.configs import get_config
        from repro_torch.configs.base import reduced
        from repro_torch.core import PilotSession
        from repro_torch.models.model import build_model
        from repro_torch.serving import ServingEngine
        params, prompts = pickle.loads(
            Path({str(jax_served[1])!r}).read_bytes())
        got = {{}}
        for arch in {SERVED!r}:
            model = build_model(reduced(get_config(arch), dtype="float32",
                                        decode_kernel=False))
            with PilotSession(device="cpu",
                              checkpoint_dir=str(out / f"ck{{rank}}")) as s:
                s.add_pilot(mesh_axes=("data", "model"), mesh_shape={mesh!r},
                            memory_gb=0.25)
                with ServingEngine(s, model, name=arch,
                                   params=params_from_numpy(params[arch],
                                                            "cpu"),
                                   batch_size={BATCH}, max_len={MAX_LEN},
                                   page_tokens=4) as eng:
                    eng.deploy()
                    reqs = [eng.submit(p, {GEN}) for p in prompts]
                    eng.drain(timeout=120)
                    got[arch] = ([r.result(timeout=5) for r in reqs],
                                 eng.stats()["refills"])
        everyone = [None] * world
        dist.all_gather_object(everyone, got)
        if rank == 0:
            (out / "port.json").write_text(json.dumps(everyone))
    """, world=mesh[1], tmp_path=tmp, timeout=240)
    return json.loads((out / "port.json").read_text())


@pytest.mark.parametrize("arch", SERVED)
def test_pilot_mesh_serves_the_jax_engines_tokens(arch, jax_served,
                                                  port_served):
    want = jax_served[0][arch]
    for ranks in port_served:
        tokens, refills = ranks[arch]
        assert tokens == want
        assert refills >= 3


# -- the card -----------------------------------------------------------------
@pytest.mark.gpu
def test_four_cards_serve_mixtral_as_one_card(tmp_path):
    """Mixtral-8x22B at its published widths, 2 of its 56 layers (the
    engine's seeded draw), greedy: in fp32 activations a (1, 4) pilot mesh
    on four cards (2 of 8 experts and 12 of 48 q heads a rank) gives each
    request the one-card engine's tokens; in bf16 the ranks' sums may flip
    near-ties, so the share of equal tokens is reported
    (``bf16_agreement``), not held."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    out = spawn("""
        import dataclasses, gc, json
        from repro_torch.configs import get_config
        from repro_torch.core import PilotSession
        from repro_torch.models.model import build_model
        from repro_torch.serving import ServingEngine
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, 32768, size=int(n)).astype(np.int32)
                   for n in rng.integers(64, 160, size=8)]

        def serve(dtype, mesh):
            cfg = dataclasses.replace(get_config("mixtral_8x22b"),
                                      num_layers=2, dtype=dtype)
            with PilotSession(device=device) as s:
                s.add_pilot(memory_gb=2, mesh_axes=("data", "model"),
                            mesh_shape=(1, 4) if mesh else ())
                with ServingEngine(s, build_model(cfg), batch_size=4,
                                   max_len=512, page_tokens=16) as eng:
                    eng.deploy()
                    reqs = [eng.submit(p, 24) for p in prompts]
                    eng.drain(timeout=600)
                    got = [r.result(timeout=10) for r in reqs]
            gc.collect()
            torch.cuda.empty_cache()
            return got

        got = {}
        for dtype in ("float32", "bfloat16"):
            got[dtype] = (serve(dtype, False), serve(dtype, True))
        one, four = got["float32"]
        assert four == one, [a == b for a, b in zip(four, one)]
        one, four = got["bfloat16"]
        same = sum(x == y for a, b in zip(one, four) for x, y in zip(a, b))
        if rank == 0:
            share = same / sum(len(a) for a in one)
            (out / "agreement.json").write_text(json.dumps({
                "bf16_agreement": share}))
            print("bf16_agreement", share)
    """, world=4, tmp_path=tmp_path, timeout=1200, backend="nccl")
    print("four cards, Mixtral-8x22B (2 layers) over a (1, 4) pilot mesh "
          "against one card:", (out / "agreement.json").read_text())


@pytest.mark.gpu
def test_four_cards_train_ep2d_as_one_card(tmp_path):
    """NCCL over a (2, 2) mesh under the EP-2D rules (the dispatch buffer
    exchanged by an all-to-all over the data axis) trains 3 fp32 steps of
    ``reduced(mixtral_8x22b)`` as the unsharded step does on each card, at
    the tolerances of the CPU cases above."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    spawn(f"""
        from repro_torch.configs import get_config
        from repro_torch.configs.base import (ParallelConfig, TrainConfig,
                                              reduced)
        from repro_torch.launch.autotune import EP2D
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.models import moe
        from repro_torch.models.common import (tree_leaves, tree_map,
                                               tree_unflatten)
        from repro_torch.models.model import build_model
        from repro_torch.parallel.sharding import AxisRules
        from repro_torch.train import steps
        model = build_model(reduced(get_config("mixtral_8x22b"),
                                    dtype="float32"))
        drawn = model.init(torch.Generator(device=device).manual_seed(0),
                           device=device)
        init = tree_unflatten(drawn, [
            t.float() * float(np.sqrt(s.shape[0] / s.shape[1]))
            if s.init == "scaled" and s.logical[0] == "layers"
            else t.float()
            for s, t in zip(tree_leaves(model.specs), tree_leaves(drawn))])
        rules = AxisRules()
        for logical, axes in EP2D:
            rules = rules.replacing(logical, axes)
        rng = np.random.default_rng(10)
        batches = [{{k: torch.from_numpy(rng.integers(
            0, model.cfg.vocab_size, (8, 32))).to(device)
            for k in ("tokens", "labels")}} for _ in range(3)]
        tcfg = TrainConfig(**{STEP_CFG!r})
        calls = [0]
        exchange = moe.all_to_all
        def counted(x, group):
            calls[0] += 1
            return exchange(x, group)
        moe.all_to_all = counted
        mesh = make_mesh((2, 2), ("data", "model"))
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
            metrics = []
            for batch in batches:
                state, m = step(state, batch)
                metrics.append({{k: float(v) for k, v in m.items()}})
            runs.append((metrics, tree_leaves(
                steps.gather_state(state.params))))
        assert calls[0] > 0, "EP-2D ran no all-to-all"
        for got, want in zip(runs[1][0], runs[0][0]):
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                           atol=1e-8, err_msg=k)
        for a, b in zip(runs[1][1], runs[0][1]):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)
    """, world=4, tmp_path=tmp_path, backend="nccl")
