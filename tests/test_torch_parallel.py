"""repro_torch's multi-device training against the JAX package, over 4
gloo ranks on the CPU (tests/_torch_dist.py), the JAX side in-process on
one device or, where it needs a mesh, in a subprocess on 4 host devices.

- ``pipeline_forward`` over a ``("pipe",)`` mesh of 4 ranks (4 stages, 8
  microbatches) equals the JAX function's output within 1e-5, and the
  sequential stack of the stages; ``bubble_fraction`` is the reference's;
- ``compressed_pod_mean`` on a (2, 2, 1) pod x data x model mesh: the
  means and residuals of two rounds (the second carrying the first's
  residuals) equal the JAX function's within 1e-6; with different grads
  on the two pods the mean is the mean of the dequantized payloads;
- the sharded train step over (4, 1) and (2, 2) data x model meshes, on
  ``reduced(llama3_2_1b)`` and ``reduced(mixtral_8x22b)`` (its softmax
  router's load-balance loss taken over the global batch; on (2, 2) its
  experts split over the model axis, 2 of 4 a rank, the routing whole on
  every rank: tests/test_torch_ep.py has the other expert layouts) in
  fp32,
  with 2 microbatches on (2, 2), on ``reduced(falcon_mamba_7b)`` (the SSM
  split over the model axis) and ``reduced(hymba_1_5b)`` at 5 q heads
  and 1 kv head (the attention whole on every rank, its SSM and FFN
  split) on (2, 2), and the reduced Llama on (1, 4), where its 4 q heads
  split and its 2 kv heads do not: the metrics of 3 steps at rtol 1e-5
  (grad norm included) and the params after them at rtol 1e-4, atol
  1e-6 against the JAX package's ``make_train_step`` on one device, from
  the same carried-over params (``carry.params_from_numpy``) — the
  tolerances of the single-device step parity in tests/test_torch_train.py
  (the JAX step jitted here); on (2, 2) a rank's q/k/v and FFN
  activations are half their whole width (the reduced Llama), and so is
  the SSM's ``xz`` (the reduced Falcon-Mamba);
- an elastic re-mesh: a (2, 2) run saves at step 2, ranks 2 and 3 leave,
  the survivors re-form a (1, 2) mesh (``ElasticController``) and
  ``restore(shardings=)`` onto it (bit for bit the saved state), and
  their step-4 state equals the uninterrupted (2, 2) run's within rtol
  1e-5, atol 1e-7 (the data axis went from 2 ranks to 1: the gradient
  means are summed in another order);
  (and a leaver may not save a tensor of the survivors' mesh);
- the training CLI over 4 ranks (``launch.train.run`` with the group
  up, a (4, 1) mesh): every rank ends with the same finite loss, rank 0
  writes the checkpoints, and a second run restores the last one
  through ``restore(shardings=)`` and goes on; a pilot lost at step 4,
  while rank 0 may still be writing step 4's checkpoint, restores step
  4 on every rank, and the ranks' losses stay equal;
- ``gpu`` tests (they import nothing of JAX: ``pytest --noconftest -m
  gpu``): a one-rank NCCL mesh on the card trains 3 steps of
  ``reduced(llama3_2_1b)`` (fp32, and bf16 with 2 microbatches) bit for
  bit as the unsharded step does, and its checkpoint restores through
  ``restore(shardings=)`` bit for bit; on four cards, NCCL over (4, 1),
  (2, 2) and (1, 4) meshes trains 3 fp32 steps as the unsharded step on
  each card does, at the tolerances of the CPU cases above.
"""
import json
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_dist import run_jax, spawn  # noqa: E402

STEP_CFG = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10)
P, M, MB, D = 4, 8, 2, 16                       # stages, microbatches, widths


def _inputs():
    rng = np.random.default_rng(0)
    ws = (rng.normal(size=(P, D, D)) * 0.3).astype(np.float32)
    xs = rng.normal(size=(M, MB, D)).astype(np.float32)
    g = {"w": rng.normal(size=(8, 16)).astype(np.float32),
         "b": rng.normal(size=(300,)).astype(np.float32)}
    g2 = {k: (v * 0.5 + 0.1).astype(np.float32) for k, v in g.items()}
    return ws, xs, g, g2


@pytest.fixture(scope="module")
def collectives(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("collectives")
    ws, xs, g, g2 = _inputs()
    np.savez(tmp / "in.npz", ws=ws, xs=xs, gw=g["w"], gb=g["b"],
             g2w=g2["w"], g2b=g2["b"])
    run_jax(f"""
        import jax, jax.numpy as jnp, numpy as np
        from repro.launch.mesh import make_mesh
        from repro.optim.compression import compressed_pod_mean, init_residuals
        from repro.parallel.pipeline import pipeline_forward
        z = np.load({str(tmp / "in.npz")!r})
        mesh = make_mesh((4,), ("pipe",))
        layer_fn = lambda w, x: jnp.tanh(x @ w)
        with mesh:
            pipe = pipeline_forward(layer_fn, jnp.asarray(z["ws"]),
                                    jnp.asarray(z["xs"]), mesh, axis="pipe")
        mesh = make_mesh((2, 2, 1), ("pod", "data", "model"))
        g = {{"w": jnp.asarray(z["gw"]), "b": jnp.asarray(z["gb"])}}
        g2 = {{"w": jnp.asarray(z["g2w"]), "b": jnp.asarray(z["g2b"])}}
        f = jax.jit(lambda g, r: compressed_pod_mean(g, r, mesh))
        with mesh:
            m1, r1 = f(g, init_residuals(g))
            m2, r2 = f(g2, r1)
        np.savez({str(tmp / "jax.npz")!r}, pipe=np.asarray(pipe),
                 **{{f"{{n}}_{{k}}": np.asarray(t[k]) for n, t in
                    (("m1", m1), ("r1", r1), ("m2", m2), ("r2", r2))
                    for k in ("w", "b")}})
    """, devices=4)
    spawn(f"""
        import numpy as np
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.optim.compression import (compressed_pod_mean,
                                                   init_residuals)
        from repro_torch.optim.quant import dequantize, quantize
        from repro_torch.parallel.pipeline import pipeline_forward
        z = np.load({str(tmp / "in.npz")!r})
        t = lambda a: torch.from_numpy(np.array(a))
        mesh = make_mesh((4,), ("pipe",))
        pipe = pipeline_forward(lambda w, x: torch.tanh(x @ w), t(z["ws"]),
                                t(z["xs"]), mesh, axis="pipe")
        mesh = make_mesh((2, 2, 1), ("pod", "data", "model"))
        g = {{"w": t(z["gw"]), "b": t(z["gb"])}}
        g2 = {{"w": t(z["g2w"]), "b": t(z["g2b"])}}
        m1, r1 = compressed_pod_mean(g, init_residuals(g), mesh)
        m2, r2 = compressed_pod_mean(g2, r1, mesh)
        # different grads on the two pods: the mean of what each sent
        pod = mesh.get_local_rank("pod")
        own = {{k: v * (1.0 + pod) for k, v in g.items()}}
        m3, _ = compressed_pod_mean(own, init_residuals(own), mesh)
        for k, v in g.items():
            sent = [dequantize(quantize(v * (1.0 + p))) for p in (0, 1)]
            assert torch.equal(m3[k], (sent[0] + sent[1]) / 2), k
        # a mesh without the axis: the grads back unchanged
        m4, r4 = compressed_pod_mean(g, r1, make_mesh((4,), ("data",)))
        assert m4 is g and r4 is r1
        np.savez(out / f"{{rank}}.npz", pipe=pipe.numpy(),
                 **{{f"{{n}}_{{k}}": t_[k].numpy() for n, t_ in
                    (("m1", m1), ("r1", r1), ("m2", m2), ("r2", r2))
                    for k in ("w", "b")}})
    """, world=4, tmp_path=tmp)
    return np.load(tmp / "jax.npz"), [np.load(tmp / "dist_out" / f"{r}.npz")
                                      for r in range(4)]


def test_pipeline_forward_matches_the_reference(collectives):
    from repro.parallel.pipeline import bubble_fraction as ref_bubble
    from repro_torch.parallel.pipeline import bubble_fraction
    want, ranks = collectives
    ws, xs, _, _ = _inputs()
    seq = xs
    for i in range(P):
        seq = np.tanh(seq @ ws[i])
    for got in ranks:                              # every rank holds it
        np.testing.assert_allclose(got["pipe"], want["pipe"], rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(got["pipe"], seq, rtol=0, atol=1e-5)
    for p, m in ((4, 8), (1, 4), (8, 2)):
        assert bubble_fraction(p, m) == ref_bubble(p, m)


def test_compressed_pod_mean_matches_the_reference(collectives):
    want, ranks = collectives
    _, _, g, _ = _inputs()
    for got in ranks:
        for name in ("m1", "r1", "m2", "r2"):
            for k in ("w", "b"):
                np.testing.assert_allclose(got[f"{name}_{k}"],
                                           want[f"{name}_{k}"], rtol=0,
                                           atol=1e-6, err_msg=name + k)
        # the reference test's bound, and error feedback at work
        for k in ("w", "b"):
            rel = np.abs(got[f"m1_{k}"] - g[k]).max() / np.abs(g[k]).max()
            assert rel < 0.02, rel
            assert np.linalg.norm(got[f"r1_{k}"]) > 0


# -- the sharded train step ------------------------------------------------------
CASES = [("llama3_2_1b", (4, 1), 1), ("llama3_2_1b", (2, 2), 1),
         ("mixtral_8x22b", (4, 1), 1), ("mixtral_8x22b", (2, 2), 1),
         ("llama3_2_1b", (2, 2), 2), ("falcon_mamba_7b", (2, 2), 1),
         ("hymba_1_5b", (2, 2), 1), ("llama3_2_1b", (1, 4), 1)]
# Hymba's heads (25 q, 5 kv) do not divide a model axis of 2 or 4: so too
# here, where the reduced config's 4 would
OVERRIDES = {"hymba_1_5b": {"num_heads": 5, "num_kv_heads": 1}}


def _case_name(arch, shape, mb):
    return f"{arch}-{shape[0]}x{shape[1]}-mb{mb}"


@pytest.fixture(scope="module")
def sharded_steps(tmp_path_factory):
    """The JAX step's metrics and params, and the port's from 4 ranks,
    for every case; and the elastic re-mesh's states."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import ParallelConfig as RefParallelConfig
    from repro.configs.base import TrainConfig as RefTrainConfig
    from repro.optim.adamw import adamw_init as ref_adamw_init
    from repro.train import steps as ref_steps
    from test_torch_train import _batch, _models

    tmp = tmp_path_factory.mktemp("sharded")
    inputs, want = {}, {}
    for arch in sorted({c[0] for c in CASES}):
        ref, port, params = _models(arch, **OVERRIDES.get(arch, {}))
        batches = [_batch(port.cfg, b=4, s=16, seed=10 + i)
                   for i in range(4)]
        inputs[arch] = (params, batches)
        for mb in sorted({c[2] for c in CASES if c[0] == arch}):
            step = jax.jit(ref_steps.make_train_step(
                ref, RefParallelConfig(microbatches=mb),
                RefTrainConfig(**STEP_CFG)))
            jp = jax.tree.map(jnp.asarray, params)
            state = ref_steps.TrainState(jp, ref_adamw_init(jp))
            metrics = []
            for batch in batches[:3]:
                state, m = step(state, {k: jnp.asarray(v)
                                        for k, v in batch.items()})
                metrics.append({k: float(v) for k, v in m.items()})
            want[arch, mb] = (metrics, [np.asarray(x) for x in
                                        jax.tree.leaves(state.params)])
    (tmp / "inputs.pkl").write_bytes(pickle.dumps(inputs))
    spawn(f"""
        import json, pickle
        from repro_torch.carry import params_from_numpy
        from repro_torch.checkpoint.checkpoint import CheckpointManager
        from repro_torch.configs import get_config
        from repro_torch.configs.base import (ParallelConfig, TrainConfig,
                                              reduced)
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.models.common import tree_leaves
        from repro_torch.models.model import build_model
        from repro_torch.optim.adamw import adamw_init
        from repro_torch.runtime.elastic import ElasticController
        from repro_torch.train import steps
        inputs = pickle.loads(Path({str(tmp / "inputs.pkl")!r}).read_bytes())
        tcfg = TrainConfig(**{STEP_CFG!r})

        def start(arch, mesh):
            model = build_model(reduced(get_config(arch), dtype="float32",
                                        **{OVERRIDES!r}.get(arch, {{}})))
            params = params_from_numpy(inputs[arch][0], "cpu")
            state = steps.TrainState(params, adamw_init(params))
            return model, steps.shard_train_state(
                state, steps.train_state_shardings(model, mesh))

        def run(model, state, mesh, batches, mb=1):
            step = steps.make_sharded_train_step(
                model, ParallelConfig(microbatches=mb), tcfg, mesh)
            metrics = []
            for batch in batches:
                state, m = step(state, {{k: torch.from_numpy(v)
                                        for k, v in batch.items()}})
                metrics.append({{k: float(v) for k, v in m.items()}})
            return state, metrics

        def dump(name, state, metrics=None):
            leaves = [t.numpy() for t in
                      tree_leaves(steps.gather_state(state))]
            if rank == 0:
                np.savez(out / f"{{name}}.npz", *leaves)
                (out / f"{{name}}.json").write_text(json.dumps(metrics))

        # the widths of a rank's activations: q/k/v heads, the FFN's and
        # the SSM's in_proj outputs
        from repro_torch.models import attention, common, ssm
        widths = {{"heads": set(), "ffn": set(), "xz": set()}}
        def record(fn, key, width):
            def wrapped(*a, **k):
                out = fn(*a, **k)
                widths[key].add(width(a, out))
                return out
            return wrapped
        attention._project = record(attention._project, "heads",
                                    lambda a, out: out.shape[-2])
        common.swiglu = record(common.swiglu, "ffn",
                               lambda a, out: a[2].shape[-1])
        ssm.linear = record(ssm.linear, "xz", lambda a, out: out.shape[-1])
        for arch, shape, mb in {CASES!r}:
            mesh = make_mesh(shape, ("data", "model"))
            model, state = start(arch, mesh)
            for v in widths.values():
                v.clear()
            state, metrics = run(model, state, mesh, inputs[arch][1][:3], mb)
            name = f"{{arch}}-{{shape[0]}}x{{shape[1]}}-mb{{mb}}"
            dump(name, state.params, metrics)
            if rank == 0:
                (out / f"{{name}}.widths.json").write_text(json.dumps(
                    {{k: sorted(v) for k, v in widths.items()}}))

        # the elastic re-mesh: (2, 2) -> ranks 2, 3 leave -> (1, 2)
        batches = inputs["llama3_2_1b"][1]
        ctl = ElasticController(model_parallel=2)
        mesh = ctl.form(list(range(world)))
        assert tuple(mesh.shape) == (2, 2), mesh
        model, state = start("llama3_2_1b", mesh)
        state, _ = run(model, state, mesh, batches[:2])
        ckpt = CheckpointManager(out / "ckpt")
        ckpt.save(2, state, blocking=True)
        dump("saved", state)
        dist.barrier()                       # the checkpoint is on disk
        state, _ = run(model, state, mesh, batches[2:])
        dump("uninterrupted", state)
        small = ctl.on_failure([0, 1])       # every rank takes part
        assert tuple(small.shape) == (1, 2) and ctl.generation == 2
        if rank < 2:
            restored, step = ckpt.restore(
                state, shardings=steps.train_state_shardings(model, small))
            assert step == 2
            assert restored.params["embed"].device_mesh is small
            dump("restored", restored)
            restored, _ = run(model, restored, small, batches[2:])
            dump("survivors", restored)
        else:
            assert small.get_coordinate() is None
            # a leaver holding a tensor of the new mesh may not save it
            from torch.distributed.tensor import DTensor, Replicate
            gone = DTensor.from_local(torch.zeros(0), small,
                                      [Replicate(), Replicate()],
                                      run_check=False)
            try:
                CheckpointManager(out / "leaver").save(5, {{"x": gone}})
                raise AssertionError("a leaver saved")
            except ValueError:
                pass
    """, world=4, tmp_path=tmp)
    return want, tmp / "dist_out"


def _leaves(path):
    z = np.load(path)
    return [z[f"arr_{i}"] for i in range(len(z.files))]


@pytest.mark.parametrize("case", CASES, ids=[_case_name(*c) for c in CASES])
def test_sharded_train_step_matches_the_reference(case, sharded_steps):
    arch, shape, mb = case
    want, out = sharded_steps
    want_metrics, want_params = want[arch, mb]
    name = _case_name(arch, shape, mb)
    got_metrics = json.loads((out / f"{name}.json").read_text())
    for got, ref in zip(got_metrics, want_metrics):
        assert sorted(got) == sorted(ref)
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=1e-8,
                                       err_msg=k)
    got_params = _leaves(out / f"{name}.npz")
    assert len(got_params) == len(want_params)
    for g, w in zip(got_params, want_params):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6)


def test_model_axis_halves_the_activations(sharded_steps):
    """At (2, 2) a rank's q/k/v heads and FFN hidden width are half the
    reduced Llama's (4 q, 2 kv heads, d_ff 128), and the SSM's xz half
    the reduced Falcon-Mamba's (2 * 128 channels): the model axis splits
    the work; at (4, 1) they are whole."""
    _, out = sharded_steps
    width = lambda name: json.loads(
        (out / f"{name}.widths.json").read_text())
    half = width("llama3_2_1b-2x2-mb1")
    assert half["heads"] == [1, 2] and half["ffn"] == [64], half
    assert width("llama3_2_1b-4x1-mb1")["heads"] == [2, 4]
    assert width("llama3_2_1b-4x1-mb1")["ffn"] == [128]
    ssm = width("falcon_mamba_7b-2x2-mb1")["xz"]
    assert max(ssm) == 128, ssm         # w_in's 2 * 64 local channels


def test_elastic_remesh_restores_onto_survivors(sharded_steps):
    _, out = sharded_steps
    for a, b in zip(_leaves(out / "restored.npz"), _leaves(out / "saved.npz")):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(_leaves(out / "survivors.npz"),
                    _leaves(out / "uninterrupted.npz")):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)


def test_train_cli_over_four_ranks(tmp_path):
    out = spawn("""
        from repro_torch.checkpoint.checkpoint import CheckpointManager
        from repro_torch.launch.train import run
        argv = ["--preset", "smoke", "--device", "cpu", "--batch", "8",
                "--seq", "32", "--ckpt-every", "3", "--log-every", "100",
                "--ckpt-dir", str(out / "ck")]
        first = run(argv + ["--steps", "4"])
        assert dict(zip(first.mesh.mesh_dim_names, first.mesh.shape)) == {
            "data": 4, "model": 1}
        second = run(argv + ["--steps", "6"])
        assert len(second.losses) == 2   # restored at step 4
        ckpt = CheckpointManager(out / "ck" / first.cfg.name)
        assert ckpt.latest_step() == 6    # on disk before run returns
        losses = torch.tensor(first.losses + second.losses)
        assert torch.isfinite(losses).all()
        everyone = [torch.zeros_like(losses) for _ in range(world)]
        dist.all_gather(everyone, losses)
        assert all(torch.equal(x, losses) for x in everyone)
    """, world=4, tmp_path=tmp_path)
    steps = sorted(p.name for p in (out / "ck").glob("*/step_*"))
    assert steps == ["step_00000003", "step_00000004", "step_00000006"]


def test_train_cli_over_four_ranks_recovers_from_one_step(tmp_path):
    spawn("""
        from repro_torch.launch.train import run
        # rank 0 writes the saves at steps 2 and 4 in the background; the
        # pilot fails at step 4, while the step-4 save may still be a .tmp
        # directory, and every rank must restore step 4
        r = run(["--preset", "smoke", "--device", "cpu", "--batch", "8",
                 "--seq", "32", "--ckpt-every", "2", "--log-every", "100",
                 "--steps", "6", "--failure-at", "4",
                 "--ckpt-dir", str(out / "ck")])
        everyone = [None] * world
        dist.all_gather_object(everyone, r.losses)
        assert all(x == r.losses for x in everyone), everyone
        assert len(r.losses) == 6, r.losses        # steps 1-4, then 5-6
        assert all(np.isfinite(r.losses))
    """, world=4, tmp_path=tmp_path)


# -- the card ------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("dtype,mb", [("float32", 1), ("bfloat16", 2)])
def test_one_rank_mesh_on_the_card_trains_as_one_device(dtype, mb, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import datetime

    import torch.distributed as dist
    from repro_torch.checkpoint.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ParallelConfig, TrainConfig, reduced
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.models.model import build_model
    from repro_torch.train import steps

    model = build_model(reduced(get_config("llama3_2_1b"), dtype=dtype))
    init = model.init(torch.Generator(device="cuda").manual_seed(0),
                      device="cuda")
    pcfg, tcfg = ParallelConfig(microbatches=mb), TrainConfig(**STEP_CFG)
    rng = np.random.default_rng(0)
    batches = [{k: torch.from_numpy(rng.integers(
        0, model.cfg.vocab_size, (4, 16))).cuda() for k in
        ("tokens", "labels")} for _ in range(3)]
    dist.init_process_group(
        "nccl", init_method=f"file://{tmp_path / 'init'}", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        runs = {}
        for sharded in (False, True):
            params = tree_map(lambda t: t.clone(), init)
            state = steps.TrainState(params, steps.adamw_init(params))
            if sharded:
                shardings = steps.train_state_shardings(model, mesh)
                state = steps.shard_train_state(state, shardings)
                step = steps.make_sharded_train_step(model, pcfg, tcfg, mesh)
            else:
                step = steps.make_train_step(model, pcfg, tcfg)
            metrics = []
            for batch in batches:
                state, m = step(state, batch)
                metrics.append({k: float(v) for k, v in m.items()})
            runs[sharded] = (metrics, state)
        assert runs[True][0] == runs[False][0]
        whole = tree_leaves(steps.gather_state(runs[True][1]))
        for a, b in zip(whole, tree_leaves(runs[False][1])):
            assert torch.equal(a, b)
        ckpt = CheckpointManager(tmp_path / "ckpt")
        ckpt.save(3, runs[True][1], blocking=True)
        restored, _ = ckpt.restore(runs[True][1], shardings=shardings)
        for a, b in zip(tree_leaves(restored), tree_leaves(runs[True][1])):
            assert torch.equal(a.to_local(), b.to_local()) if hasattr(
                a, "to_local") else torch.equal(a, b)
        dist.barrier()
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
def test_four_cards_train_as_one_card(tmp_path):
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    spawn(f"""
        from repro_torch.configs import get_config
        from repro_torch.configs.base import (ParallelConfig, TrainConfig,
                                              reduced)
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.models.common import (tree_leaves, tree_map,
                                               tree_unflatten)
        from repro_torch.models.model import build_model
        from repro_torch.train import steps
        model = build_model(reduced(get_config("llama3_2_1b"),
                                    dtype="float32"))
        drawn = model.init(torch.Generator(device=device).manual_seed(0),
                           device=device)
        # in fp32 (the specs draw some leaves in bf16), the stacked leaves
        # at 1/sqrt(fan-in), as tests/test_torch_train.py takes them: on
        # the reference's init fp32 gradients move with the order of sums
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
        for shape in ((4, 1), (2, 2), (1, 4)):
            mesh = make_mesh(shape, ("data", "model"))
            runs = []
            for sharded in (False, True):
                params = tree_map(lambda t: t.clone(), init)
                state = steps.TrainState(params, steps.adamw_init(params))
                if sharded:
                    state = steps.shard_train_state(
                        state, steps.train_state_shardings(model, mesh))
                    step = steps.make_sharded_train_step(
                        model, ParallelConfig(), tcfg, mesh)
                else:
                    step = steps.make_train_step(model, ParallelConfig(),
                                                 tcfg)
                metrics = []
                for batch in batches:
                    state, m = step(state, batch)
                    metrics.append({{k: float(v) for k, v in m.items()}})
                runs.append((metrics, tree_leaves(
                    steps.gather_state(state.params))))
            for got, want in zip(runs[1][0], runs[0][0]):
                for k in want:
                    np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                               atol=1e-8, err_msg=k)
            for a, b in zip(runs[1][1], runs[0][1]):
                torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)
    """, world=4, tmp_path=tmp_path, backend="nccl")
