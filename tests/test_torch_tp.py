"""Tensor-parallel serving over a multi-device pilot, on the CPU.

- A pilot whose description asks for a ``mesh_shape`` of more than one
  device needs a process group: with none it raises (one of one device
  gives a plain pilot).
- ``reduced(llama3_2_1b)`` in fp32 served greedily over a (1, 2) pilot
  mesh on 2 gloo ranks (``tests/_torch_dist.py``), and over a (1, 4) one
  on 4 ranks, where its 4 q heads split and its 2 kv heads do not, gives
  exactly the tokens of the JAX engine under the reference's pilot with
  ``mesh_axes=("data", "model")``, ``mesh_shape=(1, 2)`` on 2 host
  devices, on the same carried-over weights and prompts (a prefill wave,
  then refills spliced into the batched cache).  Each rank holds only its
  ``model`` shard of the leaves, in a DataUnit of its own name.
- ``vocab_argmax`` over 2 ranks breaks ties to the lowest global index,
  as ``torch.argmax`` does on the whole logits.
"""
import json
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_dist import run_jax, spawn  # noqa: E402

LENS = (6, 6, 9, 7, 6)
GEN, MAX_LEN, BATCH = 6, 32, 2


def test_multi_device_pilot_without_a_process_group_raises():
    from repro_torch.core import PilotSession
    with PilotSession(device="cpu") as s:
        with pytest.raises(ValueError, match="no process group"):
            s.add_pilot(mesh_axes=("data", "model"), mesh_shape=(1, 2))
        one = s.add_pilot(mesh_axes=("data", "model"), mesh_shape=(1, 1))
        assert one.mesh is None
    with pytest.raises(ValueError, match="mesh_shape"):
        from repro_torch.core.pilot import PilotComputeDescription
        PilotComputeDescription(mesh_shape=(0, 2), device="cpu")


@pytest.fixture(scope="module")
def jax_tokens(tmp_path_factory):
    """The JAX engine's tokens over its (1, 2) pilot mesh, and the
    params it served (the reduced Llama's init in fp32, as numpy)."""
    tmp = tmp_path_factory.mktemp("tp_serve")
    run_jax(f"""
        import json, pickle
        import jax, jax.numpy as jnp, numpy as np
        import repro.core as core
        from repro.configs import get_config
        from repro.configs.base import reduced
        from repro.models.model import build_model
        from repro.serving import ServingEngine
        model = build_model(reduced(get_config("llama3_2_1b"),
                                    dtype="float32"))
        params = jax.tree.map(lambda x: x.astype(jnp.float32),
                              model.init(jax.random.key(0)))
        rng = np.random.default_rng(5)
        prompts = [rng.integers(0, 256, size=n).astype(np.int32)
                   for n in {LENS!r}]
        with core.PilotSession() as s:
            s.add_pilots(1, num_devices=2, mesh_axes=("data", "model"),
                         mesh_shape=(1, 2), memory_gb=0.25)
            assert s.pilots[0].mesh.devices.size == 2
            with ServingEngine(s, model, params=params, batch_size={BATCH},
                               max_len={MAX_LEN}, page_tokens=4) as eng:
                eng.deploy()
                reqs = [eng.submit(p, {GEN}) for p in prompts]
                eng.drain(timeout=120)
                tokens = [r.result(timeout=5) for r in reqs]
        open({str(tmp / "jax.json")!r}, "w").write(json.dumps(tokens))
        open({str(tmp / "params.pkl")!r}, "wb").write(pickle.dumps(
            (jax.tree.map(np.asarray, params), prompts)))
    """, devices=2)
    return json.loads((tmp / "jax.json").read_text()), tmp / "params.pkl"


SERVE = """
import json, pickle
from repro_torch.carry import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.configs.base import reduced
from repro_torch.core import PilotSession
from repro_torch.models.model import build_model
from repro_torch.serving import ServingEngine
params, prompts = pickle.loads(Path(PARAMS).read_bytes())
model = build_model(reduced(get_config("llama3_2_1b"), dtype="float32",
                            decode_kernel=False))
with PilotSession(device="cpu", checkpoint_dir=str(out / f"ck{rank}")) as s:
    pilot = s.add_pilot(mesh_axes=("data", "model"), mesh_shape=MESH,
                        memory_gb=0.25)
    assert dict(zip(pilot.mesh.mesh_dim_names, pilot.mesh.shape)) == {
        "data": MESH[0], "model": MESH[1]}
    with ServingEngine(s, model, params=params_from_numpy(params, "cpu"),
                       batch_size=BATCH, max_len=MAX_LEN,
                       page_tokens=4) as eng:
        eng.deploy()
        reqs = [eng.submit(p, GEN) for p in prompts]
        eng.drain(timeout=120)
        tokens = [r.result(timeout=5) for r in reqs]
        held = sum(eng.shards.partition(i).nbytes
                   for i in range(eng.shards.num_partitions))
        stats = eng.stats()
whole = sum(np.asarray(v).nbytes for v in
            __import__("repro_torch.models.common", fromlist=["x"])
            .tree_leaves(params))
everyone = [None] * world
dist.all_gather_object(everyone, (tokens, eng.shards.name, held, whole,
                                  stats["refills"]))
if rank == 0:
    (out / "port.json").write_text(json.dumps(everyone))
"""


@pytest.mark.parametrize("mesh", [(1, 2), (1, 4)], ids=["1x2", "1x4"])
def test_pilot_mesh_serves_the_jax_engines_tokens(jax_tokens, mesh,
                                                  tmp_path):
    want, params = jax_tokens
    head = (f"PARAMS = {str(params)!r}\nMESH = {mesh!r}\n"
            f"BATCH, MAX_LEN, GEN = {BATCH}, {MAX_LEN}, {GEN}\n")
    out = spawn(head + SERVE, world=mesh[1], tmp_path=tmp_path, timeout=240)
    ranks = json.loads((out / "port.json").read_text())
    names = set()
    for tokens, name, held, whole, refills in ranks:
        assert tokens == want
        assert refills >= 3
        names.add(name)
        # a rank holds its model shard: the norms (and, at (1, 4), wk
        # and wv, whose 2 kv heads do not split 4 ways) are whole
        assert held < whole * (0.75 if mesh[1] == 2 else 0.5), (held, whole)
    assert len(names) == mesh[1]


def test_vocab_argmax_breaks_ties_to_the_lowest_index(tmp_path):
    spawn("""
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.models.common import gather_vocab, vocab_argmax
        from repro_torch.parallel.sharding import sharding_context
        mesh = make_mesh((1, 2), ("data", "model"))
        whole = torch.tensor([[0., 3., 1., 3., 2., 3.],     # tie 1, 3, 5
                              [5., 0., 0., 0., 0., 5.],     # tie 0 and 5
                              [0., 0., 0., 0., 9., 0.]])    # on rank 1
        local = whole[:, rank * 3:(rank + 1) * 3]
        with sharding_context(mesh):
            got = vocab_argmax(local, 6)
            back = gather_vocab(local, 6)
        assert got.tolist() == torch.argmax(whole, -1).tolist() == [1, 0, 4]
        assert torch.equal(back, whole)
    """, world=2, tmp_path=tmp_path)


@pytest.mark.parametrize("whole", [(), ("kv_heads",),
                                   ("heads", "kv_heads", "ssm_inner")],
                         ids=["default", "kv_whole", "heads_ssm_whole"])
def test_cache_is_cut_by_the_rules_that_cut_the_weights(tmp_path, whole):
    """A rank's cache (its kv heads and SSM channels) follows the sharding
    context's rules as its weights do: reduced Hymba (4 q and 2 kv heads
    beside an SSM) over (1, 2), with the rules keeping `whole` logical
    axes whole, prefills the shapes ``cache_spec(local=True)`` gives, and
    its prefill and decode logits are the whole model's."""
    spawn(f"""
        from repro_torch.configs import get_config
        from repro_torch.configs.base import reduced
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.models.common import gather_vocab
        from repro_torch.models.model import build_model
        from repro_torch.models.transformer import local_leaf, tp_layouts
        from repro_torch.parallel.sharding import AxisRules, sharding_context
        from repro_torch.serving.engine import (flatten_params,
                                                unflatten_params)
        cfg = reduced(get_config("hymba_1_5b"), dtype="float32")
        model = build_model(cfg)
        params = model.init(torch.Generator().manual_seed(0), device="cpu")
        rules = AxisRules()
        for name in {whole!r}:
            rules = rules.replacing(name, None)
        mesh = make_mesh((1, 2), ("data", "model"))
        specs = dict(flatten_params(model.specs))
        lays = dict(flatten_params(tp_layouts(model.specs, cfg)))
        pairs = flatten_params(params)
        local = unflatten_params(
            [p for p, _ in pairs],
            [local_leaf(t, specs[p], lays[p], mesh, rules) for p, t in pairs])
        tokens = torch.as_tensor(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (2, 8)), dtype=torch.int32)
        pos = torch.full((2,), 8, dtype=torch.int32)
        ref, ref_cache = model.prefill(params, {{"tokens": tokens}}, 16)
        nxt = ref.argmax(-1, keepdim=True).to(torch.int32)
        ref_step, _ = model.decode(params, ref_cache, nxt, pos)
        with sharding_context(mesh, rules):
            spec = model.cache_spec(2, 16, local=True)
            got, cache = model.prefill(local, {{"tokens": tokens}}, 16)
            got = gather_vocab(got, cfg.vocab_size)
            step, _ = model.decode(local, cache, nxt, pos)
            step = gather_vocab(step, cfg.vocab_size)
        for layer, layer_spec in zip(cache, spec):
            for group in ("kv", "ssm"):
                for key, (shape, _) in layer_spec[group].items():
                    assert tuple(layer[group][key].shape) == shape, (
                        group, key, tuple(layer[group][key].shape), shape)
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(step, ref_step, rtol=1e-5, atol=1e-5)
    """, world=2, tmp_path=tmp_path)


def test_cli_model_parallel_and_mesh_over_ranks(tmp_path):
    """``launch.train --model-parallel 2`` over 4 gloo ranks trains on a
    (2, 2) mesh, every rank with the same finite losses; ``launch.serve
    --mesh 1x2`` over 2 ranks serves every request its tokens, alike on
    both, and refuses 4 ranks."""
    spawn("""
        from repro_torch.launch.serve import main as serve
        from repro_torch.launch.train import run
        r = run(["--preset", "smoke", "--device", "cpu", "--batch", "8",
                 "--seq", "32", "--steps", "3", "--log-every", "100",
                 "--model-parallel", "2", "--ckpt-dir", str(out / "ck")])
        assert dict(zip(r.mesh.mesh_dim_names, r.mesh.shape)) == {
            "data": 2, "model": 2}
        everyone = [None] * world
        dist.all_gather_object(everyone, r.losses)
        assert all(x == r.losses for x in everyone), everyone
        assert len(r.losses) == 3 and all(np.isfinite(r.losses))
        try:                     # a (1, 2) mesh does not span 4 ranks
            serve(["--mesh", "1x2", "--preset", "smoke", "--device", "cpu"])
        except ValueError as e:
            assert "4 ranks" in str(e), e
        else:
            raise AssertionError("--mesh 1x2 served over 4 ranks")
    """, world=4, tmp_path=tmp_path, timeout=240)
    out = spawn("""
        import json
        from repro_torch.launch.serve import main as serve
        st = serve(["--mesh", "1x2", "--preset", "smoke", "--device", "cpu",
                    "--requests", "4", "--batch", "2", "--prompt-len", "4",
                    "--prompt-len-max", "8", "--gen", "5", "--max-len", "32"])
        everyone = [None] * world
        dist.all_gather_object(everyone, st["tokens"])
        assert everyone[0] == everyone[1]
        assert st["tokens_served"] == 20, st
    """, world=2, tmp_path=tmp_path / "serve", timeout=240)


@pytest.mark.gpu
def test_four_cards_serve_the_one_card_tokens(tmp_path):
    """Llama-3.2-1B at its published widths (the engine's seeded draw),
    greedy: in fp32 activations the (1, 4), (4, 1) and (2, 2) pilot
    meshes on four cards (heads split four ways; the batch of 4 split
    into a row a rank; both halved) give each request the one-card
    engine's tokens; in bf16 the tensor-parallel sums may flip near-ties,
    so the share of equal tokens over (1, 4) is reported
    (``bf16_agreement`` in rank 0's output), not held."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    out = spawn("""
        import dataclasses, json
        from repro_torch.configs import get_config
        from repro_torch.core import PilotSession
        from repro_torch.models.model import build_model
        from repro_torch.serving import ServingEngine
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, 128256, size=int(n)).astype(np.int32)
                   for n in rng.integers(64, 160, size=8)]

        def serve(dtype, mesh):
            cfg = dataclasses.replace(get_config("llama3_2_1b"), dtype=dtype)
            with PilotSession(device=device) as s:
                s.add_pilot(memory_gb=4, mesh_axes=("data", "model"),
                            mesh_shape=mesh)
                with ServingEngine(s, build_model(cfg), batch_size=4,
                                   max_len=512, page_tokens=16) as eng:
                    eng.deploy()
                    reqs = [eng.submit(p, 24) for p in prompts]
                    eng.drain(timeout=600)
                    assert eng.stats()["rows_local"] == 4 // (
                        mesh[0] if mesh else 1)
                    return [r.result(timeout=10) for r in reqs]

        one = serve("float32", ())
        for mesh in ((1, 4), (4, 1), (2, 2)):
            four = serve("float32", mesh)
            assert four == one, (mesh, [a == b for a, b in zip(four, one)])
        one, four = serve("bfloat16", ()), serve("bfloat16", (1, 4))
        same = sum(x == y for a, b in zip(one, four) for x, y in zip(a, b))
        if rank == 0:
            (out / "agreement.json").write_text(json.dumps({
                "bf16_agreement": same / sum(len(a) for a in one)}))
            print("bf16_agreement", same / sum(len(a) for a in one))
    """, world=4, tmp_path=tmp_path, timeout=900, backend="nccl")
    print("four cards, (1, 4) pilot mesh against one card:",
          (out / "agreement.json").read_text())
