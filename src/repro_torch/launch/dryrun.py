"""Multi-pod dry-run: plan every (arch x shape x mesh) cell on fake tensors.

    python -m repro_torch.launch.dryrun --all
    python -m repro_torch.launch.dryrun --arch llama3_2_1b --shape train_4k
    python -m repro_torch.launch.dryrun --arch llama3_2_1b --shape train_4k \
        --mesh 4x1 --batch 8 --seq 1024      # the cell a 4-card run measures

The port of ``repro/launch/dryrun.py``, which lowers and compiles each
cell on 512 placeholder host devices.  Here a cell's step runs once,
eagerly, under ``FakeTensorMode`` (shapes, no data) over a fake default
process group of the mesh's size (``ensure_fake_world``: its collectives
return at once and move nothing), as rank 0 of the mesh; every rank does
the same work.  While it runs, ``roofline.op_cost.OpCost`` counts the
rank's FLOPs, HBM bytes and collective bytes and ``MemTracker`` its live
tensor bytes (``PEAK_METHOD``).  The fake group is the counterpart of
the reference's ``XLA_FLAGS``: it fixes the rank count for the process,
and a process that plans must not also run a real group, so the dry-run
runs in its own process.

What a cell runs, as one rank of the mesh:
- train: ``make_sharded_train_step`` on ``shard_train_state`` DTensors
  placed by the rules, with the global batch (the port's step takes it
  on every rank and keeps its slice, and runs the model on the rank's
  ``model`` shard of the params);
- prefill and decode: ``make_prefill_step``/``make_decode_step`` inside
  a ``sharding_context`` over the mesh, on the rank's serving params
  (its ``model`` shard of each leaf by ``transformer.tp_layouts``, whole
  over the batch axes, as ``serving/engine.py`` holds them), the rank's
  slice of the batch (cut by the "batch" rule) and its cache (that batch
  slice, its kv heads and SSM channels: ``cache_spec(local=True)``).
The record gives the bytes a rank holds at rest (``resident_bytes``)
and its peak (``peak_mem_bytes``, which decides ``fits_hbm``).

Over a ``model`` axis the step runs tensor-parallel
(``models/transformer.py``; MoE expert-parallel, MLA over its heads): a
rank's FLOPs fall with the axis, and the all-reduces of the row-parallel
outputs count under "all-reduce" (``roofline.op_cost``).  Under rules
that also put the experts on a batch axis (EP-2D) a training cell holds
a rank's experts there instead of gathering them, and the dispatch
buffer's exchange counts under "all-to-all".  Records are written to
``build/dryrun/<arch>__<shape>__<mesh>.json``.  Besides the reference's
production meshes (``--mesh pod|multipod|both``), ``--mesh`` takes any
mesh (``DxM`` or ``PxDxM``) and ``--batch``/``--seq`` resize the shape:
a plan of what a card run measures (``chip_smoke.py`` plans its
training cell so); ``--rules seq_parallel`` plans under
``("seq", "model")``, where the model runs sequence-parallel
(``models/transformer.py``).  A train cell with int8 AdamW state
(``ParallelConfig.opt_state_dtype``, from ``autotune``/``hillclimb``)
holds each rank's blocks (``quant.block_layout``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import ParallelConfig, SHAPES, TrainConfig
from repro_torch.launch.mesh import PRODUCTION_MESH, make_mesh
from repro_torch.models.common import (abstract_params, param_pspecs,
                                       tree_leaves, tree_map, tree_unflatten)
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import adamw_init
from repro_torch.models.transformer import local_leaf, tp_layouts
from repro_torch.parallel.sharding import (AxisRules, PartitionSpec,
                                           axis_sizes, shard_shape,
                                           sharding_context)
from repro_torch.roofline import analysis as ra
from repro_torch.train import steps as steps_mod
from repro_torch.train.steps import TrainState

DEFAULT_OUT = Path(__file__).resolve().parents[3] / "build" / "dryrun"
PEAK_METHOD = ("MemTracker (torch.distributed._tools.mem_tracker) under "
               "FakeTensorMode: the live tensor storage of one rank's step, "
               "its inputs included; no allocator rounding or "
               "fragmentation")


def mesh_name(multi_pod: bool) -> str:
    return "x".join(map(str, PRODUCTION_MESH[multi_pod][0]))


def skip_reason(cfg, shape) -> str | None:
    if shape.name == "long_500k" and not cfg.supports_long_decode:
        return ("full-attention arch: 512k dense-KV decode is not "
                "serveable")
    return None


def ensure_fake_world(world: int) -> None:
    """Make the default process group a fake one of `world` ranks, this
    process rank 0 (reused if it is one already; a real group raises)."""
    import torch.distributed as dist
    # importing it registers the "fake" backend's constructor
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("a dry-run plans over a fake process group "
                               "and needs a process of its own; this one "
                               f"runs a {dist.get_backend()} group")
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def local_shape(shape, pspec, mesh) -> tuple:
    """A rank's shard shape of a tensor of `shape` placed by `pspec`."""
    sizes = axis_sizes(mesh)
    out = list(shape)
    for d, entry in enumerate(pspec):
        for a in ((entry,) if isinstance(entry, str) else entry or ()):
            out[d] //= sizes[a]
    return tuple(out)


def _batch_rules(rules: AxisRules) -> AxisRules:
    """`rules` cut to the "batch" entries: a serve step's rank slice."""
    return AxisRules(tuple(r for r in rules.rules if r[0] == "batch"))


def _pairs(meta_tree, pspecs):
    """(meta leaf, its PartitionSpec) in leaf order."""
    return zip(tree_leaves(meta_tree), tree_leaves(
        pspecs, is_leaf=lambda x: isinstance(x, PartitionSpec)))


def _local(meta_tree, pspecs, mesh):
    """Fake tensors of each meta leaf's rank shard shape."""
    return tree_unflatten(meta_tree, [
        torch.empty(local_shape(m.shape, ps, mesh), dtype=m.dtype)
        for m, ps in _pairs(meta_tree, pspecs)])


def _nbytes(tree) -> int:
    total = 0
    for t in tree_leaves(tree):
        t = t.to_local() if hasattr(t, "to_local") else t
        total += t.numel() * t.element_size()
    return total


def _shard_bytes(meta_tree, pspecs, mesh) -> int:
    return sum(
        torch.Size(local_shape(m.shape, ps, mesh)).numel() * m.element_size()
        for m, ps in _pairs(meta_tree, pspecs))


def serving_params(model, mesh, rules: AxisRules):
    """Meta tensors of the rank's serving leaves: each leaf's ``model``
    shard by ``transformer.tp_layouts`` (``local_leaf``), whole over the
    batch axes."""
    meta = abstract_params(model.specs)
    return tree_unflatten(meta, [
        torch.empty(local_leaf(m, spec, lay, mesh, rules).shape,
                    dtype=m.dtype, device="meta")
        for m, spec, lay in zip(tree_leaves(meta), tree_leaves(model.specs),
                                tree_leaves(tp_layouts(model.specs,
                                                       model.cfg)))])


def serving_cache(model, shape, mesh, rules: AxisRules):
    """Meta tensors of the rank's decode cache at `shape`: its slice of
    the batch, its kv heads and SSM channels."""
    with sharding_context(mesh, rules):
        spec = model.cache_spec(shape.global_batch, shape.seq_len,
                                local=True)
    meta, ps = steps_mod.cache_specs(model, shape, mesh,
                                     _batch_rules(rules), spec=spec)
    return tree_unflatten(meta, [
        torch.empty(local_shape(m.shape, p, mesh), dtype=m.dtype,
                    device="meta") for m, p in _pairs(meta, ps)])


def build_lowerable(cfg, shape, mesh, rules: AxisRules, pcfg: ParallelConfig):
    """Returns (step, example_args), the args fake tensors of one rank:
    call it inside a ``FakeTensorMode`` over a fake group spanning
    `mesh`, and ``step(*args)`` plans the cell."""
    model = build_model(cfg)
    whole = lambda tree: tree_map(
        lambda m: torch.empty(m.shape, dtype=m.dtype), tree)

    if shape.kind == "train":
        params = whole(abstract_params(model.specs))
        step = steps_mod.make_sharded_train_step(model, pcfg, TrainConfig(),
                                                 mesh, rules)
        state = TrainState(params, adamw_init(params, pcfg.opt_state_dtype))
        state = steps_mod.shard_train_state(
            state, steps_mod.train_state_shardings(model, mesh, rules,
                                                   pcfg.opt_state_dtype))
        batch, _ = steps_mod.batch_specs(cfg, shape, mesh, rules)
        return step, (state, whole(batch))

    params = whole(serving_params(model, mesh, rules))
    batch = _local(*steps_mod.batch_specs(cfg, shape, mesh,
                                          _batch_rules(rules)), mesh)

    def in_context(step):
        def run(*args):
            with sharding_context(mesh, rules):
                return step(*args)
        return run

    if shape.kind == "prefill":
        return (in_context(steps_mod.make_prefill_step(
            model, max_len=shape.seq_len)), (params, batch))
    cache = whole(serving_cache(model, shape, mesh, rules))
    return (in_context(steps_mod.make_decode_step(model)),
            (params, cache, batch["tokens"], batch["positions"]))


def resident_bytes(cfg, shape, mesh, rules: AxisRules,
                   pcfg: ParallelConfig) -> dict:
    """The bytes a rank holds at rest, by part: in training the params,
    AdamW moments and count at the rules' placements and its batch slice;
    in serving its serving params (`serving_params`), its batch slice
    and its cache (`serving_cache`)."""
    model = build_model(cfg)
    meta = abstract_params(model.specs)
    if shape.kind != "train":
        out = {"params": _nbytes(serving_params(model, mesh, rules)),
               "batch": _shard_bytes(*steps_mod.batch_specs(
                   cfg, shape, mesh, _batch_rules(rules)), mesh)}
        if shape.kind == "decode":
            out["cache"] = _nbytes(serving_cache(model, shape, mesh, rules))
        return out
    ps = param_pspecs(model.specs, mesh, rules)
    out = {"params": _shard_bytes(meta, ps, mesh)}
    opt = adamw_init(meta, pcfg.opt_state_dtype)   # on the meta device
    if pcfg.opt_state_dtype == "int8":
        # a rank's blocks and scales (``quant.block_layout``)
        sh = steps_mod.train_state_shardings(model, mesh, rules, "int8")
        out["opt_state"] = sum(
            math.prod(shard_shape(s.shape, mesh, s.placements))
            * t.element_size()
            for t, s in zip(tree_leaves((opt.m, opt.v)), tree_leaves(
                (sh.opt_state.m, sh.opt_state.v))))
    else:
        out["opt_state"] = (_shard_bytes(opt.m, ps, mesh)
                            + _shard_bytes(opt.v, ps, mesh))
    out["opt_state"] += opt.count.element_size()
    out["batch"] = _shard_bytes(*steps_mod.batch_specs(cfg, shape, mesh,
                                                       rules), mesh)
    return out


def plan_cell(cfg, shape, mesh, rules: AxisRules | None = None,
              pcfg: ParallelConfig | None = None, *, arch: str = "",
              mesh_label: str = "") -> dict:
    """Plan one cell on `mesh` (a DeviceMesh over a fake default group):
    its per-rank bytes, peak memory and roofline."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    from repro_torch.roofline.op_cost import OpCost
    rules = rules or AxisRules()
    pcfg = pcfg or ParallelConfig()
    sizes = axis_sizes(mesh)
    chips = mesh.size()
    mesh_label = mesh_label or "x".join(map(str, mesh.shape))
    t0 = time.perf_counter()
    with FakeTensorMode():
        step, args = build_lowerable(cfg, shape, mesh, rules, pcfg)
        mem = MemTracker()
        mem.track_external(*tree_leaves(args))
        with mem, OpCost() as counter:
            step(*args)
        peak = max(snap["Total"] for snap in
                   mem.get_tracker_snapshot("peak").values())
    plan_s = time.perf_counter() - t0
    at_rest = resident_bytes(cfg, shape, mesh, rules, pcfg)
    inputs = _nbytes(args)
    roof = ra.analyze(counter.cost, arch=arch or cfg.name, shape=shape.name,
                      mesh_name=mesh_label, chips=chips,
                      model_flops=ra.model_flops_estimate(cfg, shape),
                      peak_mem_bytes=float(peak),
                      arg_bytes=float(sum(at_rest.values())))
    rec = {"status": "ok", "plan_s": plan_s,
           "mesh_shape": dict(sizes),
           "resident_bytes": at_rest,
           "step_input_bytes": inputs,
           "activation_peak_bytes": peak - inputs,
           "peak_method": PEAK_METHOD,
           "roofline": roof.to_dict(),
           "fits_hbm": bool(peak <= ra.HBM_PER_CHIP),
           "hbm_per_chip": ra.HBM_PER_CHIP}
    return rec


def apply_cfg_patch(cfg, patch: dict):
    """Apply {"field": v, "sub.field": v} overrides to a frozen config."""
    nested: dict = {}
    flat: dict = {}
    for key, val in patch.items():
        if "." in key:
            sub, field = key.split(".", 1)
            nested.setdefault(sub, {})[field] = val
        else:
            flat[key] = val
    for sub, fields in nested.items():
        flat[sub] = dataclasses.replace(getattr(cfg, sub), **fields)
    return dataclasses.replace(cfg, **flat)


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: Path,
             rules: AxisRules | None = None,
             pcfg: ParallelConfig | None = None, tag: str = "",
             cfg_patch: dict | None = None) -> dict:
    """Plan a cell on the production mesh, (16, 16) or (2, 16, 16), over
    a fake group of 256 or 512 ranks in this process."""
    return plan_named_cell(arch, SHAPES[shape_name],
                           PRODUCTION_MESH[multi_pod][0], rules, pcfg, tag,
                           cfg_patch)


def plan_named_cell(arch: str, shape, mesh_shape: tuple,
                    rules: AxisRules | None = None,
                    pcfg: ParallelConfig | None = None, tag: str = "",
                    cfg_patch: dict | None = None) -> dict:
    """Plan `arch` at `shape` (a ShapeConfig) on a mesh of `mesh_shape`
    ((data, model) or (pod, data, model)) over a fake group of its size
    in this process."""
    cfg = get_config(arch)
    if cfg_patch:
        cfg = apply_cfg_patch(cfg, cfg_patch)
    label = "x".join(map(str, mesh_shape))
    rec: dict = {"arch": arch, "shape": shape.name, "mesh": label,
                 "tag": tag}
    reason = skip_reason(cfg, shape)
    if reason:
        rec["status"] = "skipped"
        rec["reason"] = reason
        return rec
    ensure_fake_world(math.prod(mesh_shape))
    axes = PRODUCTION_MESH[len(mesh_shape) == 3][1]
    mesh = make_mesh(tuple(mesh_shape), axes)
    rec.update(plan_cell(cfg, shape, mesh, rules, pcfg, arch=arch,
                         mesh_label=label))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    help="pod | multipod | both, or a mesh DxM (data x "
                         "model) or PxDxM to plan over, e.g. 4x1")
    ap.add_argument("--batch", type=int, default=None,
                    help="global batch in place of the shape's")
    ap.add_argument("--seq", type=int, default=None,
                    help="sequence length in place of the shape's")
    ap.add_argument("--rules", default="default",
                    choices=("default", "seq_parallel"),
                    help="seq_parallel: the rule overrides of "
                         "``launch.autotune``'s candidate of that name")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    args = ap.parse_args(argv)
    from repro_torch.launch.autotune import SP
    rules = AxisRules()
    for logical, axes in (SP if args.rules == "seq_parallel" else ()):
        rules = rules.replacing(logical, axes)
    tag = "" if args.rules == "default" else f"_{args.rules}"

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    named = {"pod": [False], "multipod": [True], "both": [False, True]}
    meshes = ([PRODUCTION_MESH[m][0] for m in named[args.mesh]]
              if args.mesh in named
              else [tuple(int(n) for n in args.mesh.split("x"))])

    failures = 0
    for mesh_shape in meshes:         # one fake group size at a time
        for arch in archs:
            for shape_name in shapes:
                shape = SHAPES[shape_name]
                if args.batch or args.seq:
                    shape = dataclasses.replace(
                        shape, global_batch=args.batch or shape.global_batch,
                        seq_len=args.seq or shape.seq_len,
                        name=f"{shape_name}_b{args.batch or shape.global_batch}"
                             f"_s{args.seq or shape.seq_len}")
                name = "x".join(map(str, mesh_shape))
                path = out_dir / f"{arch}__{shape.name}__{name}{tag}.json"
                if path.exists() and not args.force:
                    rec = json.loads(path.read_text())
                    print(f"[cached] {arch} {shape.name} {name}: "
                          f"{rec.get('status')}")
                    continue
                try:
                    rec = plan_named_cell(arch, shape, mesh_shape, rules,
                                          tag=args.rules)
                except Exception as e:  # noqa: BLE001 - record and continue
                    rec = {"arch": arch, "shape": shape.name,
                           "mesh": name, "status": "error",
                           "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-4000:]}
                    failures += 1
                path.write_text(json.dumps(rec, indent=2, default=str))
                status = rec.get("status")
                extra = ""
                if status == "ok":
                    r = rec["roofline"]
                    extra = (f" t_c={r['t_compute']:.3e}s"
                             f" t_m={r['t_memory']:.3e}s"
                             f" t_coll={r['t_collective']:.3e}s"
                             f" bottleneck={r['bottleneck']}"
                             f" peak_mem={r['peak_mem_bytes'] / 2**30:.2f}GiB"
                             f" plan={rec['plan_s']:.1f}s")
                elif status == "error":
                    extra = " " + rec["error"][:160]
                print(f"[{status}] {arch} {shape.name} {name}{extra}",
                      flush=True)
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
