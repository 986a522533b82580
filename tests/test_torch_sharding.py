"""repro_torch.parallel.sharding and launch.mesh against the JAX package.

- ``resolve_pspec`` gives the reference's PartitionSpec on every case of
  tests/test_sharding.py and on a grid of logical axes, shapes, meshes
  and rule tables (abstract meshes on both sides);
- ``placements`` turns a spec into one DTensor placement per mesh dim;
- on a (2, 2) ``("data", "model")`` mesh of 4 gloo ranks, each rank's
  ``to_local()`` of ``shard_tensor`` equals the slice that JAX's
  ``NamedSharding.devices_indices_map`` gives the device at the same mesh
  coordinate (4 host devices in a JAX subprocess), and equals
  ``distribute_tensor``'s own layout; ``with_logical_constraint``
  redistributes a DTensor and leaves a plain tensor alone; the params of
  ``reduced(llama3_2_1b)`` placed by ``param_pspecs`` gather back whole;
- ``param_pspecs``, ``batch_specs`` and ``cache_specs`` give the
  reference's PartitionSpecs (and shapes and dtypes) for every family at
  a train, a prefill and a decode shape on an abstract (2, 16, 16) mesh.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_dist import run_jax, spawn  # noqa: E402
from repro_torch.launch.mesh import make_abstract_mesh  # noqa: E402
from repro_torch.parallel.sharding import (AxisRules,  # noqa: E402
                                           PartitionSpec, placements,
                                           resolve_pspec)

LOGICALS = ["batch", "seq", "embed", "heads", "kv_heads", "mlp", "vocab",
            "expert", "layers", "long_seq", "expert_mlp", None]
SIZES = [1, 2, 3, 4, 8, 16, 25, 36, 48, 129, 524288]
MESHES = [((2, 16, 16), ("pod", "data", "model")),
          ((16, 16), ("data", "model")), ((4, 1), ("data", "model")),
          ((2, 2), ("data", "model")), ((1, 2), ("data", "model")),
          ((2, 2, 1), ("pod", "data", "model")), ((8,), ("data",))]
RULES = {"default": (), "seq_over_model": (("seq", "model"),),
         "embed_fallback": (("embed", ("pod", "data")),)}


def _ref(dims, sizes, shape, axes, over):
    from repro.launch.mesh import make_abstract_mesh as ref_mesh
    from repro.parallel.sharding import AxisRules as RefRules
    from repro.parallel.sharding import resolve_pspec as ref_resolve
    return tuple(ref_resolve(dims, sizes, ref_mesh(shape, axes),
                             RefRules().override(*over)))


def _port(dims, sizes, shape, axes, over):
    return tuple(resolve_pspec(dims, sizes, make_abstract_mesh(shape, axes),
                               AxisRules().override(*over)))


# the named cases of tests/test_sharding.py, with the value each asserts
CASES = [
    ((16, 16), ("data", "model"), ("embed", "kv_heads", "head_dim"),
     (4096, 8, 128), (), ("data",)),
    ((16, 16), ("data", "model"), ("expert", "expert_embed", "expert_mlp"),
     (8, 6144, 16384), (), (None, "data", "model")),
    ((16, 16), ("data", "model"), ("expert", "expert_embed", "expert_mlp"),
     (256, 7168, 2048), (), ("model", "data")),
    ((16, 16), ("data", "model"), ("batch", "seq"), (256, 4096),
     (("seq", "model"),), ("data", "model")),
    ((16, 16), ("data", "model"), ("batch", "long_seq"), (1, 524288), (),
     (None, ("data", "model"))),
]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_resolve_pspec_named_cases(case):
    shape, axes, dims, sizes, over, want = CASES[case]
    got = _port(dims, sizes, shape, axes, over)
    assert got == want
    assert got == _ref(dims, sizes, shape, axes, over)


@pytest.mark.parametrize("rules", sorted(RULES))
@pytest.mark.parametrize("mesh", range(len(MESHES)))
def test_resolve_pspec_grid_matches_the_reference(mesh, rules):
    shape, axes = MESHES[mesh]
    over = RULES[rules]
    rng = np.random.default_rng(mesh * 7 + len(rules))
    mesh_sizes = dict(zip(axes, shape))
    for _ in range(120):
        n = int(rng.integers(1, 5))
        dims = [LOGICALS[i] for i in rng.integers(0, len(LOGICALS), n)]
        sizes = [SIZES[i] for i in rng.integers(0, len(SIZES), n)]
        got = _port(dims, sizes, shape, axes, over)
        assert got == _ref(dims, sizes, shape, axes, over), (dims, sizes)
        used = []
        for entry, size in zip(got, sizes):     # the reference's invariants
            names = (entry,) if isinstance(entry, str) else tuple(entry or ())
            assert size % int(np.prod([mesh_sizes[a] for a in names])) == 0
            used += names
        assert len(used) == len(set(used))


def test_placements_per_mesh_dim():
    from torch.distributed.tensor import Replicate, Shard
    mesh = make_abstract_mesh((2, 2, 4), ("pod", "data", "model"))
    assert placements(PartitionSpec(("pod", "data"), None, "model"),
                      mesh) == [Shard(0), Shard(0), Shard(2)]
    assert placements(PartitionSpec(), mesh) == [Replicate()] * 3
    assert placements(PartitionSpec(None, "data"), mesh) == [
        Replicate(), Shard(1), Replicate()]
    with pytest.raises(NotImplementedError, match="order"):
        placements(PartitionSpec(("model", "data")), mesh)


# (logical axes, shape) placed on a (2, 2) data x model mesh
LAYOUTS = [(("embed", "mlp"), (8, 12)), (("batch", "seq"), (4, 6)),
           (("vocab", "embed"), (6, 4)), (("layers", "embed", "heads"),
                                          (3, 4, 2)),
           (("batch", "long_seq"), (1, 8)), (("kv_heads", None), (3, 5))]


def test_local_shards_match_jax_devices_indices_map(tmp_path):
    want = json.loads(run_jax(f"""
        import json, jax, numpy as np
        from jax.sharding import NamedSharding
        from repro.launch.mesh import make_mesh
        from repro.parallel.sharding import AxisRules, resolve_pspec
        mesh = make_mesh((2, 2), ("data", "model"))
        out = []
        for dims, shape in {LAYOUTS!r}:
            ns = NamedSharding(mesh, resolve_pspec(dims, shape, mesh,
                                                   AxisRules()))
            idx = ns.devices_indices_map(tuple(shape))
            x = np.arange(int(np.prod(shape))).reshape(shape)
            per = {{}}
            for (i, j), dev in np.ndenumerate(mesh.devices):
                per[2 * i + j] = x[idx[dev]].tolist()
            out.append(per)
        print(json.dumps(out))
    """, devices=4).strip().splitlines()[-1])
    out = spawn(f"""
        import json
        import numpy as np
        from torch.distributed.tensor import distribute_tensor
        from repro_torch.configs import get_config
        from repro_torch.configs.base import reduced
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.models.common import param_pspecs, tree_leaves
        from repro_torch.models.model import build_model
        from repro_torch.parallel.sharding import (
            AxisRules, placements, resolve_pspec, shard_tensor,
            sharding_context, with_logical_constraint)
        from repro_torch.train.steps import gather_state
        mesh = make_mesh((2, 2), ("data", "model"))
        assert mesh.get_coordinate() == [rank // 2, rank % 2] or \\
            tuple(mesh.get_coordinate()) == (rank // 2, rank % 2)
        rows = []
        for dims, shape in {LAYOUTS!r}:
            pl = placements(resolve_pspec(dims, shape, mesh, AxisRules()),
                            mesh)
            x = torch.arange(int(np.prod(shape))).reshape(shape)
            mine = shard_tensor(x, mesh, pl)
            assert torch.equal(mine.to_local(),
                               distribute_tensor(x, mesh, pl).to_local())
            assert torch.equal(mine.full_tensor(), x)
            rows.append(mine.to_local().tolist())
        (out / f"{{rank}}.json").write_text(json.dumps(rows))

        # with_logical_constraint: a DTensor is redistributed, a plain
        # tensor passes through
        x = torch.arange(32.).reshape(4, 8)
        rep = distribute_tensor(x, mesh, placements((), mesh))
        with sharding_context(mesh, AxisRules()):
            got = with_logical_constraint(rep, "batch", "act_mlp")
            assert with_logical_constraint(x, "batch", "act_mlp") is x
        assert [str(p) for p in got.placements] == ["S(0)", "S(1)"], \\
            got.placements
        assert torch.equal(got.to_local(),
                           x[2 * (rank // 2):2 * (rank // 2) + 2,
                             4 * (rank % 2):4 * (rank % 2) + 4])

        # a model's params placed by param_pspecs gather back whole
        model = build_model(reduced(get_config("llama3_2_1b")))
        params = model.init(torch.Generator().manual_seed(0), device="cpu")
        specs = tree_leaves(model.specs)
        ps = tree_leaves(param_pspecs(model.specs, mesh, AxisRules()),
                         is_leaf=lambda s: isinstance(s, tuple))
        placed = [shard_tensor(p, mesh, placements(s, mesh))
                  for p, s in zip(tree_leaves(params), ps)]
        assert any(d.to_local().numel() < d.numel() for d in placed)
        for p, d in zip(tree_leaves(params), gather_state(placed)):
            assert torch.equal(p, d)
    """, world=4, tmp_path=tmp_path)
    for rank in range(4):
        got = json.loads((out / f"{rank}.json").read_text())
        for layout, rows, per in zip(LAYOUTS, got, want):
            assert rows == per[str(rank)], (layout, rank)


SPEC_FAMILIES = ["llama3_2_1b", "hymba_1_5b", "falcon_mamba_7b",
                 "mixtral_8x22b", "deepseek_v3_671b", "whisper_base",
                 "internvl2_2b"]


def _flat(tree, path=()):
    """{path: leaf} of a nested dict/tuple tree, dict keys sorted as
    ``jax.tree`` walks them (a PartitionSpec, a tuple subclass, stays a
    leaf)."""
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree)
                for k, v in _flat(tree[key], path + (key,)).items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields") \
            and type(tree) in (list, tuple):
        return {k: v for i, x in enumerate(tree)
                for k, v in _flat(x, path + (i,)).items()}
    return {path: tree}


@pytest.mark.parametrize("arch", SPEC_FAMILIES)
def test_param_batch_and_cache_specs_match_the_reference(arch):
    import dataclasses

    import jax
    from repro.configs import get_config as ref_get_config
    from repro.configs.base import SHAPES as REF_SHAPES
    from repro.configs.base import reduced as ref_reduced
    from repro.launch.mesh import make_abstract_mesh as ref_mesh
    from repro.models.common import param_pspecs as ref_param_pspecs
    from repro.models.model import build_model as ref_build_model
    from repro.parallel.sharding import AxisRules as RefRules
    from repro.train import steps as ref_steps
    from repro_torch.configs import get_config
    from repro_torch.configs.base import SHAPES, reduced
    from repro_torch.models.common import abstract_params, param_pspecs
    from repro_torch.models.model import build_model
    from repro_torch.train import steps

    shape, axes = (2, 16, 16), ("pod", "data", "model")
    mesh, rmesh = make_abstract_mesh(shape, axes), ref_mesh(shape, axes)
    over = dict(num_layers=2)
    port = build_model(reduced(get_config(arch), **over))
    ref = ref_build_model(ref_reduced(ref_get_config(arch), **over))
    is_p = lambda x: isinstance(x, jax.sharding.PartitionSpec)

    def same(got, want):
        want = jax.tree_util.tree_flatten_with_path(want, is_leaf=is_p)[0]
        got = _flat(got)
        assert len(got) == len(want)
        for (path, w), g in zip(want, got.values()):
            assert tuple(g) == tuple(w), jax.tree_util.keystr(path)

    same(param_pspecs(port.specs, mesh, AxisRules()),
         ref_param_pspecs(ref.specs, rmesh, RefRules()))
    meta = [t for t in _flat(abstract_params(port.specs)).values()]
    assert all(t.device.type == "meta" for t in meta)
    assert [tuple(t.shape) for t in meta] == [
        tuple(s.shape) for s in jax.tree.leaves(
            ref_steps.jax.eval_shape(lambda: ref.init(jax.random.key(0))))]
    for name in ("train_4k", "prefill_32k", "decode_32k"):
        sh = dataclasses.replace(SHAPES[name], seq_len=512, global_batch=32)
        rsh = dataclasses.replace(REF_SHAPES[name], seq_len=512,
                                  global_batch=32)
        meta, ps = steps.batch_specs(port.cfg, sh, mesh, AxisRules())
        rsds, rps = ref_steps.batch_specs(ref.cfg, rsh, rmesh, RefRules())
        assert sorted(meta) == sorted(rsds)
        for k in rsds:
            assert tuple(meta[k].shape) == rsds[k].shape
            assert str(meta[k].dtype).split(".")[-1] == str(rsds[k].dtype)
            assert tuple(ps[k]) == tuple(rps[k])
        if name == "decode_32k":
            meta, ps = steps.cache_specs(port, sh, mesh, AxisRules())
            rsds, rps = ref_steps.cache_specs(ref, rsh, rmesh, RefRules())
            same(ps, rps)
            want = jax.tree.leaves(rsds)
            got = list(_flat(meta).values())
            assert [(tuple(t.shape), str(t.dtype).split(".")[-1])
                    for t in got] == [(s.shape, str(s.dtype)) for s in want]


def test_sharded_step_refuses_int8_state():
    """The sharded step takes int8 AdamW state now (it refused it before
    the blocks were laid out over the ranks, ``quant.block_layout``):
    every leaf of Llama-3.2-1B that the rules cut has its blocks cut over
    as many ranks.  On (2, 2) each rank's shard is whole blocks of the
    leaf (updated where it lies); on (1, 4) the kv projections' shards
    (2 heads of 64) are not, and their blocks lie cut on an outer dim."""
    import math
    from torch.distributed.tensor import Shard
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.optim.quant import block_layout
    from repro_torch.parallel.sharding import AxisRules, named_sharding
    from repro_torch.serving.engine import flatten_params
    model = build_model(get_config("llama3_2_1b"))
    for shape, moved in (((2, 2), set()),
                         ((1, 4), {"layers/attn/wk", "layers/attn/wv"})):
        mesh = make_abstract_mesh(shape, ("data", "model"))
        got = set()
        for path, spec in flatten_params(model.specs):
            place = named_sharding(spec.logical, spec.shape, mesh,
                                   AxisRules()).placements
            lay = block_layout(spec.shape, mesh, place)
            ranks = lambda pl: math.prod(n for n, p in zip(mesh.shape, pl)
                                         if isinstance(p, Shard))
            assert ranks(lay.placements) == ranks(place), (path, shape)
            assert lay.cut is not None, (path, shape)
            assert math.prod(lay.data_shape) == math.prod(spec.shape)
            if lay.cut != tuple(place):
                got.add("/".join(path))
        assert got == moved, (shape, got)
