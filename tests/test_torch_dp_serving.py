"""Serving with the batch split over a pilot mesh's data axis, on the CPU.

The reference's rules send ``("batch", ("pod", "data"))``, and its engine
prefills and decodes under the pilot mesh's sharding context: over a
(D, M) pilot mesh each data group computes B/D rows.  The port's engine
gives data group g rows ``[g*B/D, (g+1)*B/D)`` of its cache and logits,
runs its model under the ``model`` sub-mesh's context, and all-gathers
the sampled tokens over the batch group each pass.

- ``reduced(llama3_2_1b)`` in fp32, greedy, batch 4, over (2, 1) and
  (2, 2) ``("data", "model")`` pilot meshes, a (4,) ``("data",)`` one and
  a (2, 2) ``("pod", "data")`` one (one flattened batch group of 4) on
  gloo ranks (``tests/_torch_dist.py``), gives every rank exactly the
  tokens of the JAX engine over its (2, 2) pilot mesh on 4 host devices,
  on the carried-over weights, with ragged prompts so that refills are
  spliced into single groups; every rank's cache holds B/D rows.  Batch
  3 over (2, 1) stays whole (3 rows a rank) and gives the JAX engine's
  batch-3 tokens.
- ``reduced(mixtral_8x22b)`` over (2, 2) (experts split over ``model``,
  dispatch inside a group) and ``reduced(hymba_1_5b)`` over (2, 1) (the
  hybrid tuple cache spliced at a local row) give the JAX engine's tokens
  over the same meshes, and so does ``reduced(falcon_mamba_7b)`` (the SSM
  family: the stacked conv history and state) over (2, 1) (two rows a
  rank) and over (1, 2) (the batch whole, the inner channels of
  ``w_in``, the conv, the state and ``w_out`` split over ``model``).  MoE decode merges rows into capacity groups of
  2E/k tokens (4 here), which the reference forms over the whole batch:
  at batch 8 over (2, 2) each data group holds whole groups and the batch
  is split; at batch 4 the one group spans both data groups, and the
  batch stays whole on every rank (``moe.groups_nest``), with the same
  tokens.
- No collective inside prefill or decode spans data groups: every
  collective of a serving run is recorded with its group, and the only
  ones over more than one data group are the admission broadcast of
  every loop pass and the token all-gather of every pass that samples.
- ``launch.serve --mesh 2x1`` over 2 ranks serves every request its
  tokens, alike on both ranks, at 2 rows a rank.
- On four cards (a ``gpu`` test, run by ``tools/ssm_four_cards.sh``):
  reduced Falcon-Mamba in fp32 over (1, 4), (4, 1) and (2, 2) pilot meshes
  gives every request one card's tokens.
"""
import json
import math

import pytest

torch = pytest.importorskip("torch")

from _torch_dist import run_jax, spawn  # noqa: E402

LENS = (6, 6, 9, 7, 6, 8, 6)
GEN, MAX_LEN = 6, 32
# (name, arch, batch, mesh axes, mesh shape) of the JAX engine's runs
JAX_RUNS = (("llama", "llama3_2_1b", 4, ("data", "model"), (2, 2)),
            ("llama_b3", "llama3_2_1b", 3, ("data", "model"), (2, 2)),
            ("mixtral", "mixtral_8x22b", 8, ("data", "model"), (2, 2)),
            ("mixtral_b4", "mixtral_8x22b", 4, ("data", "model"), (2, 2)),
            ("hymba", "hymba_1_5b", 4, ("data", "model"), (2, 1)),
            ("falcon", "falcon_mamba_7b", 4, ("data", "model"), (2, 1)),
            ("falcon_1x2", "falcon_mamba_7b", 4, ("data", "model"), (1, 2)))
# (name, the JAX run it is held to, batch, mesh axes, mesh shape) on 4
# ranks and on 2
FOUR = (("llama 2x2", "llama", 4, ("data", "model"), (2, 2)),
        ("llama 4", "llama", 4, ("data",), (4,)),
        ("llama pod 2x2", "llama", 4, ("pod", "data"), (2, 2)),
        ("mixtral 2x2", "mixtral", 8, ("data", "model"), (2, 2)),
        ("mixtral b4 2x2", "mixtral_b4", 4, ("data", "model"), (2, 2)))
TWO = (("llama 2x1", "llama", 4, ("data", "model"), (2, 1)),
       ("llama b3 2x1", "llama_b3", 3, ("data", "model"), (2, 1)),
       ("hymba 2x1", "hymba", 4, ("data", "model"), (2, 1)),
       ("falcon 2x1", "falcon", 4, ("data", "model"), (2, 1)),
       ("falcon 1x2", "falcon_1x2", 4, ("data", "model"), (1, 2)))
# the runs whose batch stays whole on every rank: D does not divide it,
# or an MoE capacity group would span data groups
WHOLE = {"llama b3 2x1", "mixtral b4 2x2"}
ARCH = {name: arch for name, arch, *_ in JAX_RUNS}


@pytest.fixture(scope="module")
def jax_served(tmp_path_factory):
    """The JAX engine's tokens for each of `JAX_RUNS` (its refill count
    beside them), and the params and prompts it served."""
    tmp = tmp_path_factory.mktemp("dp_serve")
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
        for name, arch, batch, axes, shape in {JAX_RUNS!r}:
            model = build_model(reduced(get_config(arch), dtype="float32"))
            if arch not in params:
                params[arch] = jax.tree.map(lambda x: x.astype(jnp.float32),
                                            model.init(jax.random.key(0)))
            with core.PilotSession() as s:
                s.add_pilots(1, num_devices=int(np.prod(shape)),
                             mesh_axes=axes, mesh_shape=shape,
                             memory_gb=0.25)
                with ServingEngine(s, model, params=params[arch],
                                   batch_size=batch, max_len={MAX_LEN},
                                   page_tokens=4) as eng:
                    eng.deploy()
                    reqs = [eng.submit(q, {GEN}) for q in prompts]
                    eng.drain(timeout=120)
                    tokens[name] = ([r.result(timeout=5) for r in reqs],
                                    eng.stats()["refills"])
        open({str(tmp / "jax.json")!r}, "w").write(json.dumps(tokens))
        open({str(tmp / "params.pkl")!r}, "wb").write(pickle.dumps(
            ({{a: jax.tree.map(np.asarray, p) for a, p in params.items()}},
             prompts)))
    """, devices=4, timeout=240)
    return json.loads((tmp / "jax.json").read_text()), tmp / "params.pkl"


# every rank serves each run, recording the collectives it issues (the
# process group's ranks of each) while the engine is deployed
SERVE = """
import json, pickle
import torch.distributed as dist
from repro_torch.carry import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.configs.base import reduced
from repro_torch.core import PilotSession
from repro_torch.models.model import build_model
from repro_torch.parallel.sharding import (AxisRules, model_mesh,
                                           sharding_context)
from repro_torch.serving import ServingEngine


def spec_shapes(spec):     # the leaf shapes of a cache_spec tree
    if isinstance(spec, dict):
        return [x for k in sorted(spec) for x in spec_shapes(spec[k])]
    if all(isinstance(n, int) for n in spec[0]):
        return [spec[0]]
    return [x for part in spec for x in spec_shapes(part)]


params, prompts = pickle.loads(Path(PARAMS).read_bytes())
calls = []
for fn in ("all_reduce", "all_gather", "all_gather_into_tensor", "broadcast",
           "all_to_all_single", "reduce_scatter_tensor"):
    def wrap(*a, _f=getattr(dist, fn), _n=fn, **k):
        g = k.get("group")
        calls.append((_n, dist.get_process_group_ranks(g) if g is not None
                      else list(range(world))))
        return _f(*a, **k)
    setattr(dist, fn, wrap)
got = {}
for name, arch, batch, axes, shape in RUNS:
    model = build_model(reduced(get_config(arch), dtype="float32",
                                decode_kernel=False))
    with PilotSession(device="cpu",
                      checkpoint_dir=str(out / f"ck{rank}")) as s:
        pilot = s.add_pilot(mesh_axes=axes, mesh_shape=shape, memory_gb=0.25)
        with ServingEngine(s, model, name=arch,
                           params=params_from_numpy(params[arch], "cpu"),
                           batch_size=batch, max_len=MAX_LEN,
                           page_tokens=4) as eng:
            del calls[:]
            eng.deploy()
            reqs = [eng.submit(p, GEN) for p in prompts]
            eng.drain(timeout=120)
            seen = list(calls)
            stats = eng.stats()
            tokens = [r.result(timeout=5) for r in reqs]
        # the cache of `rows_local` rows a rank holds, from the model's
        # cache spec under the rank's model sub-mesh (fp32 and int32: 4
        # bytes an element)
        sub = model_mesh(pilot.mesh, AxisRules())
        with (sharding_context(sub) if sub is not None
              else __import__("contextlib").nullcontext()):
            spec = model.cache_spec(stats["rows_local"], MAX_LEN, local=True)
        want_bytes = sum(4 * int(np.prod(shape)) for shape in spec_shapes(spec))
    got[name] = {"tokens": tokens, "rows_local": stats["rows_local"],
                 "cache_bytes": stats["cache_bytes"],
                 "want_bytes": want_bytes, "refills": stats["refills"],
                 "passes": sum(n == "broadcast" for n, _ in seen),
                 "collectives": seen}
everyone = [None] * world
dist.all_gather_object(everyone, got)
if rank == 0:
    (out / "port.json").write_text(json.dumps(everyone))
"""


def _served(jax_served, runs, world, tmp_path_factory):
    tmp = tmp_path_factory.mktemp(f"dp_serve_{world}")
    head = (f"PARAMS = {str(jax_served[1])!r}\n"
            f"RUNS = {[(n, ARCH[j], b, a, s) for n, j, b, a, s in runs]!r}\n"
            f"MAX_LEN, GEN = {MAX_LEN}, {GEN}\n")
    out = spawn(head + SERVE, world=world, tmp_path=tmp, timeout=300)
    return json.loads((out / "port.json").read_text())


@pytest.fixture(scope="module")
def four_ranks(jax_served, tmp_path_factory):
    return _served(jax_served, FOUR, 4, tmp_path_factory)


@pytest.fixture(scope="module")
def two_ranks(jax_served, tmp_path_factory):
    return _served(jax_served, TWO, 2, tmp_path_factory)


def _dims(axes, shape):
    """(D, M): the sizes of the mesh's batch dims and of the others."""
    d = math.prod(n for a, n in zip(axes, shape) if a in ("pod", "data"))
    return d, math.prod(shape) // d


def _ranks(name, four_ranks, two_ranks):
    return [r[name] for r in (four_ranks if name in {n for n, *_ in FOUR}
                              else two_ranks)]


@pytest.mark.parametrize("run", FOUR + TWO, ids=[r[0] for r in FOUR + TWO])
def test_every_rank_serves_the_jax_engines_tokens(run, jax_served,
                                                  four_ranks, two_ranks):
    name, held_to, batch, axes, shape = run
    want, jax_refills = jax_served[0][held_to]
    # ragged prompts: a wave takes at most the first two (of length 6),
    # the rest are refills, however the requests' arrival falls
    assert jax_refills >= 3
    for got in _ranks(name, four_ranks, two_ranks):
        assert got["tokens"] == want
        assert got["refills"] >= 3


@pytest.mark.parametrize("run", FOUR + TWO, ids=[r[0] for r in FOUR + TWO])
def test_a_rank_holds_its_data_groups_rows(run, four_ranks, two_ranks):
    """B/D rows of cache a rank where the batch is split, all B where it
    stays whole (`WHOLE`)."""
    name, _, batch, axes, shape = run
    d, _ = _dims(axes, shape)
    assert name in WHOLE or batch % d == 0
    rows = batch if name in WHOLE else batch // d
    for got in _ranks(name, four_ranks, two_ranks):
        assert got["rows_local"] == rows
        assert got["cache_bytes"] == got["want_bytes"] > 0


@pytest.mark.parametrize("run", FOUR + TWO, ids=[r[0] for r in FOUR + TWO])
def test_no_collective_of_the_model_spans_data_groups(run, four_ranks,
                                                      two_ranks):
    """The collectives whose group holds ranks of more than one data
    group are the admission broadcast of every loop pass and, where the
    batch is split, the token all-gather of every pass that samples.
    Everything else runs inside a data group (the model's
    tensor-parallel collectives)."""
    name, _, _, axes, shape = run
    d, m = _dims(axes, shape)

    def groups(ranks):       # the data groups of a (D, M) mesh's ranks
        return {r // m for r in ranks}

    for got in _ranks(name, four_ranks, two_ranks):
        wide = [n for n, ranks in got["collectives"]
                if len(groups(ranks)) > 1]
        if d == 1:           # one data group: no collective spans two
            assert wide == [], wide
            assert any(len(r) == m for _, r in got["collectives"])
            continue
        gathers = wide.count("all_gather_into_tensor")
        assert set(wide) <= {"broadcast", "all_gather_into_tensor"}, wide
        assert wide.count("broadcast") == got["passes"] > 0
        # a pass samples once a token of each of the GEN a request
        assert gathers == 0 if name in WHOLE else gathers >= GEN, gathers
        assert gathers < got["passes"]     # deploy's broadcast besides
        if m > 1:   # the model group's own collectives ran
            assert any(len(groups(r)) == 1 and len(r) == m
                       for _, r in got["collectives"])


def test_cli_mesh_2x1_splits_the_batch(tmp_path):
    """``launch.serve --mesh 2x1`` over 2 ranks serves every request its
    tokens, alike on both ranks, with 2 of the 4 rows a rank; greedy and
    sampled (each group draws its own rows, the all-gather shares
    them)."""
    spawn("""
        from repro_torch.launch.serve import main as serve
        for temperature in ("0", "1.0"):
            st = serve(["--mesh", "2x1", "--preset", "smoke", "--device",
                        "cpu", "--requests", "6", "--batch", "4",
                        "--prompt-len", "4", "--prompt-len-max", "8",
                        "--gen", "5", "--max-len", "32",
                        "--temperature", temperature])
            everyone = [None] * world
            dist.all_gather_object(everyone, st["tokens"])
            assert everyone[0] == everyone[1]
            assert st["tokens_served"] == 30 and st["completed"] == 6, st
            assert st["rows_local"] == 2, st
    """, world=2, tmp_path=tmp_path, timeout=240)


@pytest.mark.parametrize("rows,split", [(8, True), (16, True), (4, False)],
                         ids=["8", "16", "4"])
def test_moe_decode_groups_nest_in_the_data_groups(rows, split):
    """MoE decode merges rows into capacity groups of 2E/k tokens (4 for
    the reduced Mixtral).  Where the whole batch's groups divide among
    two data groups (``moe.groups_nest``), the two halves of a decode
    batch, each routed on its own as a data group does, give the whole
    batch's output: the same groups, the same capacity.  At 4 rows the
    whole batch is one group of 4, the halves two of 2: their capacities
    differ (4 * 2 * 1.25 / 4 = 2 slots an expert against 1) and, here,
    so do the outputs; the engine keeps such a batch whole."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import reduced
    from repro_torch.models import moe
    from repro_torch.models.common import init_params
    cfg = reduced(get_config("mixtral_8x22b"), dtype="float32")
    assert 2 * cfg.moe.num_experts // cfg.moe.top_k == 4
    assert moe.groups_nest(cfg, rows, 2) == split
    params = init_params(moe.moe_specs(cfg),
                         torch.Generator().manual_seed(0), device="cpu")
    x = torch.randn((rows, 1, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    whole, _ = moe.moe_ffn(params, x, cfg)
    half = rows // 2
    halves = torch.cat([moe.moe_ffn(params, x[:half], cfg)[0],
                        moe.moe_ffn(params, x[half:], cfg)[0]])
    if split:
        torch.testing.assert_close(halves, whole, rtol=0, atol=0)
    else:
        assert not torch.equal(halves, whole)


# (arch, batch, D, whether the batch splits): the published configs' decode
# groups, 2E/k tokens (8 for Mixtral, 64 for DeepSeek-V3), each inside one
# data group only where the whole batch's group count divides by D; at
# prefill lengths s with s * k < E the groups hold s tokens of a row
@pytest.mark.parametrize("arch,batch,d,split", [
    ("mixtral_8x22b", 8, 2, False), ("mixtral_8x22b", 16, 2, True),
    ("mixtral_8x22b", 16, 4, False), ("mixtral_8x22b", 32, 4, True),
    ("mixtral_8x22b", 24, 2, False), ("deepseek_v3_671b", 64, 2, False),
    ("deepseek_v3_671b", 256, 4, True), ("llama3_2_1b", 8, 4, True)])
def test_published_moe_batches_split_only_where_groups_nest(arch, batch, d,
                                                            split):
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    assert moe.groups_nest(get_config(arch), batch, d) == split


# reduced Falcon-Mamba served greedily in fp32 over a pilot mesh and on one
# device of each rank; run by test_four_ssm_cards_serve_the_one_card_tokens
# under NCCL (one card a rank), rehearsed under gloo on the CPU
SSM_MESHES = """
import json
from repro_torch.configs import get_config
from repro_torch.configs.base import reduced
from repro_torch.core import PilotSession
from repro_torch.models.model import build_model
from repro_torch.serving import ServingEngine
cfg = reduced(get_config("falcon_mamba_7b"), dtype="float32")
rng = np.random.default_rng(0)
prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32)
           for n in rng.integers(6, 20, size=8)]


def serve(mesh):
    with PilotSession(device=device or "cpu",
                      checkpoint_dir=str(out / f"ck{rank}")) as s:
        s.add_pilot(memory_gb=0.25, mesh_axes=("data", "model"),
                    mesh_shape=mesh)
        with ServingEngine(s, build_model(cfg), batch_size=4, max_len=64,
                           page_tokens=4) as eng:
            eng.deploy()
            reqs = [eng.submit(p, 12) for p in prompts]
            eng.drain(timeout=600)
            st = eng.stats()
            assert st["rows_local"] == 4 // (mesh[0] if mesh else 1), st
            assert st["refills"] >= 3, st
            return [r.result(timeout=10) for r in reqs]


one = serve(())
for mesh in ((1, 4), (4, 1), (2, 2)):
    got = serve(mesh)
    assert got == one, (mesh, [a == b for a, b in zip(got, one)])
if rank == 0:
    (out / "ssm_meshes.json").write_text(json.dumps(one))
"""


@pytest.mark.gpu
def test_four_ssm_cards_serve_the_one_card_tokens(tmp_path):
    """Reduced Falcon-Mamba (fp32, greedy, the engine's seeded draw): over
    the (1, 4) pilot mesh (its 128 inner channels 32 a card), the (4, 1)
    one (a row a card) and the (2, 2) one (both halved) on four cards,
    with the selective_scan kernel on each rank's prefill, every request
    gets the one-card engine's tokens."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    out = spawn(SSM_MESHES, world=4, tmp_path=tmp_path, timeout=600,
                backend="nccl")
    print("four cards, Falcon-Mamba (reduced) over (1, 4), (4, 1), (2, 2):",
          "tokens equal one card's for",
          len(json.loads((out / "ssm_meshes.json").read_text())),
          "requests")
