"""The port's roofline (``repro_torch.roofline``) against the JAX
package's, and its op counter (``op_cost``) on fake tensors, on the CPU.

The reference's cases that parse no HLO are ported: the roofline's terms
and bottleneck (at the H100's peaks), ``model_flops_estimate`` (equal to
the reference's for every config and shape) and the ring model of
collective bytes (the reference's ``_traffic_factor``, here on the c10d
ops of a fake 16-rank group, in a subprocess).  A kernel dispatcher
meeting a fake tensor is charged as one op with the kernel's own work
(``analysis.*_cost``), not its plain version's.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.roofline import analysis as ra  # noqa: E402
from repro_torch.roofline.op_cost import OpCost, _traffic_factor  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"


def test_roofline_terms_and_bottleneck():
    from repro.roofline.analysis import Roofline as JaxRoofline
    r = ra.Roofline(arch="a", shape="s", mesh="m", chips=256,
                    flops_per_device=ra.PEAK_FLOPS,
                    bytes_per_device=ra.HBM_BW * 2,
                    coll_bytes_per_device=ra.LINK_BW * 0.5,
                    coll_by_kind={}, peak_mem_bytes=1, arg_bytes=1,
                    model_flops=1.0, hlo_flops_global=2.0)
    assert r.t_compute == pytest.approx(1.0)
    assert r.t_memory == pytest.approx(2.0)
    assert r.t_collective == pytest.approx(0.5)
    assert r.bottleneck == "memory"
    assert r.roofline_fraction == pytest.approx(0.5)
    assert r.useful_flops_ratio == pytest.approx(0.5)
    ref = JaxRoofline(arch="a", shape="s", mesh="m", chips=256,
                      flops_per_device=197e12, bytes_per_device=819e9 * 2,
                      coll_bytes_per_device=50e9 * 0.5, coll_by_kind={},
                      peak_mem_bytes=1, arg_bytes=1, model_flops=1.0,
                      hlo_flops_global=2.0)
    assert set(ref.to_dict()) <= set(r.to_dict())
    for k in ("t_compute", "t_memory", "t_collective", "roofline_fraction",
              "useful_flops_ratio"):
        assert r.to_dict()[k] == pytest.approx(ref.to_dict()[k])
    assert (ra.PEAK_FLOPS, ra.HBM_BW, ra.LINK_BW) == (989e12, 3.35e12, 450e9)


def test_model_flops_estimate_moe_uses_active():
    from repro.configs import ARCH_IDS as JAX_ARCHS, get_config as jax_config
    from repro.configs.base import SHAPES as JAX_SHAPES
    from repro.roofline.analysis import model_flops_estimate as jax_estimate
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.configs.base import SHAPES
    assert list(ARCH_IDS) == list(JAX_ARCHS)
    for arch in ARCH_IDS:
        for name, shape in SHAPES.items():
            assert ra.model_flops_estimate(get_config(arch), shape) == \
                jax_estimate(jax_config(arch), JAX_SHAPES[name]), (arch, name)
    cfg = get_config("deepseek_v3_671b")
    dense_equiv = 6.0 * cfg.num_params() * 256 * 4096
    active = ra.model_flops_estimate(cfg, SHAPES["train_4k"])
    assert active < 0.2 * dense_equiv  # top-8/256 + shared << dense


def test_traffic_factor_is_the_references():
    from repro.roofline.hlo_cost import _traffic_factor as jax_factor
    for kind in ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                 "collective-permute"):
        for group in (1, 2, 8, 16, 256):
            assert _traffic_factor(kind, group) == jax_factor(kind, group)


def test_collective_bytes_ring_model():
    """Each c10d op a step can issue, over a group of 8 of a fake 16-rank
    world: its full buffer times the ring factor of 8."""
    code = textwrap.dedent("""
        import json
        import torch, torch.distributed as dist
        import torch.distributed._functional_collectives as funcol
        from torch._subclasses.fake_tensor import FakeTensorMode
        from repro_torch.launch import dryrun
        from repro_torch.roofline.op_cost import OpCost
        dryrun.ensure_fake_world(16)
        group = dist.new_group(list(range(8)))
        out = {}
        with FakeTensorMode():
            x = torch.zeros(64)                       # f32[64], 256 bytes
            for name, fn in (
                    ("c10d all_reduce", lambda: dist.all_reduce(x, group=group)),
                    ("funcol all_reduce",
                     lambda: funcol.all_reduce(x, "sum", group)),
                    ("all_gather", lambda: funcol.all_gather_tensor(
                        x, 0, group)),
                    ("reduce_scatter", lambda: funcol.reduce_scatter_tensor(
                        x, "sum", 0, group)),
                    ("c10d all_gather", lambda: dist.all_gather_into_tensor(
                        torch.empty(512), x, group=group))):
                with OpCost() as counter:
                    fn()
                c = counter.cost
                out[name] = [c.coll_bytes, c.coll_by_kind, c.coll_count]
        print(json.dumps(out))
    """)
    env = {**os.environ, "PYTHONPATH": str(SRC), "PYTHONWARNINGS": "ignore"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    ring = 7 / 8
    for name in ("c10d all_reduce", "funcol all_reduce"):
        # ring all-reduce over 8: 2*(7/8)*256 bytes
        assert got[name] == [2 * ring * 256, {"all-reduce": 2 * ring * 256},
                             1], name
    assert got["all_gather"] == [ring * 2048, {"all-gather": ring * 2048}, 1]
    assert got["c10d all_gather"] == got["all_gather"]
    assert got["reduce_scatter"] == [ring * 256,
                                     {"reduce-scatter": ring * 256}, 1]


def _fake(mode, *shapes_dtypes):
    with mode:
        return [torch.empty(s, dtype=d) for s, d in shapes_dtypes]


def test_op_cost_counts_io_bytes_and_frees_views():
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        a = torch.empty(16, 32)
        b = torch.empty(32, 8)
        with OpCost() as counter:
            a.t()[:4].unsqueeze(0), a.reshape(-1)   # views: free
            c = a @ b                           # mm: reads a, b, writes c
            c.add_(1.0)                         # reads and writes c
    cost = counter.cost
    mm_bytes = (16 * 32 + 32 * 8 + 16 * 8) * 4
    assert cost.flops == 2 * 16 * 32 * 8
    assert cost.by_opcode_bytes == {"mm": mm_bytes, "add_": 2 * 16 * 8 * 4}
    assert cost.hbm_bytes == mm_bytes + 2 * 16 * 8 * 4
    # under inference_mode matmul reaches the counter whole: it is
    # counted as the mm it runs (serve steps run so)
    with FakeTensorMode():
        x, w = torch.empty(2, 16, 32), torch.empty(32, 8)
        with torch.inference_mode(), OpCost() as counter:
            x @ w
    assert counter.cost.flops == 2 * 2 * 16 * 32 * 8


def _kernel_cases():
    f32, bf16 = torch.float32, torch.bfloat16
    from repro_torch.kernels.decode_attention.ops import decode_attention_op
    from repro_torch.kernels.flash_attention.ops import flash_attention_op
    from repro_torch.kernels.kmeans.ops import kmeans_assign_op
    from repro_torch.kernels.selective_scan.ops import selective_scan_op
    b, s, nq, nkv, h = 2, 48, 4, 2, 16
    return {
        "flash_attention": (
            lambda *a: flash_attention_op(*a, window=16),
            [((b, s, nq, h), bf16), ((b, s, nkv, h), bf16),
             ((b, s, nkv, h), bf16)],
            ra.flash_cost(b, s, s, nq, nkv, h, 2, True, 16)[:2]),
        "decode_attention": (
            decode_attention_op,
            [((b, nq, h), bf16), ((b, 64, nkv, h), bf16),
             ((b, 64, nkv, h), bf16), ((b, 64), torch.int32),
             ((b,), torch.int32)],
            ra.attention_cost(b, 64, nq, nkv, h, 2, b * 64)[:2]),
        "selective_scan": (
            selective_scan_op,
            [((b, s, 24), f32), ((b, s, 24), f32), ((24, 4), f32),
             ((b, s, 4), f32), ((b, s, 4), f32), ((24,), f32)],
            ra.scan_cost(b, s, 24, 4, 4)[:2]),
        "kmeans_assign": (
            kmeans_assign_op, [((100, 8), f32), ((5, 8), f32)],
            ra.kmeans_cost(100, 5, 8, 4)[:2]),
    }


@pytest.mark.parametrize("name", ["flash_attention", "decode_attention",
                                  "selective_scan", "kmeans_assign"])
def test_planned_kernel_is_one_op_with_its_work(name):
    """On fake tensors a dispatcher returns empty outputs shaped as its
    plain version's and charges the kernel's FLOPs and bytes once."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    op, args, (flops, nbytes) = _kernel_cases()[name]
    mode = FakeTensorMode()
    fake = _fake(mode, *args)
    with mode, torch.no_grad(), OpCost() as counter:
        out = op(*fake)
    assert counter.cost.kernel_calls == {name: 1}
    assert counter.cost.flops == flops
    assert counter.cost.by_opcode_bytes == {name: nbytes}
    rng = np.random.default_rng(0)
    real = [torch.from_numpy(rng.integers(0, 4, s).astype(np.int32))
            if d == torch.int32 else
            torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(d)
            for s, d in args]
    want = op(*real)                                  # the plain version
    flat = lambda x: list(x) if isinstance(x, tuple) else [x]
    assert [(t.shape, t.dtype) for t in flat(out)] == \
        [(t.shape, t.dtype) for t in flat(want)]


def test_flash_cost_counts_the_mask():
    for sq, skv, causal, window in ((40, 40, True, 0), (40, 40, True, 7),
                                    (9, 30, False, 0), (30, 30, False, 5)):
        i = np.arange(sq)[:, None]
        j = np.arange(skv)[None, :]
        mask = np.ones((sq, skv), dtype=bool)
        if causal:
            mask &= j <= i
        if window:
            mask &= i - j < window
            mask &= j >= i - window + 1
        _, _, _, pairs = ra.flash_cost(1, sq, skv, 2, 1, 8, 2, causal,
                                       window)
        assert pairs == int(mask.sum()), (sq, skv, causal, window)


def test_prefill_charges_flash_attention_not_its_ref(monkeypatch):
    """A prefill at 2048 tokens on fake tensors: each layer's attention is
    one flash_attention op of flash_cost's bytes; run through the plain
    version instead, the same prefill is charged at least one fp32 score
    matrix a layer more, which the card never allocates."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.configs import get_config
    from repro_torch.configs.base import reduced
    from repro_torch.kernels.flash_attention.ops import flash_attention_op
    from repro_torch.models import attention
    from repro_torch.models.common import abstract_params, tree_map
    from repro_torch.models.model import build_model
    from repro_torch.train.steps import make_prefill_step
    cfg = reduced(get_config("llama3_2_1b"), num_layers=2,
                  dtype="bfloat16")
    model = build_model(cfg)
    b, s = 2, 2048

    def plan():
        with FakeTensorMode():
            params = tree_map(lambda m: torch.empty(m.shape, dtype=m.dtype),
                              abstract_params(model.specs))
            batch = {"tokens": torch.empty((b, s), dtype=torch.int32)}
            with OpCost() as counter:
                make_prefill_step(model, max_len=s)(params, batch)
        return counter.cost

    cost = plan()
    _, nbytes, _, _ = ra.flash_cost(b, s, s, cfg.num_heads, cfg.num_kv_heads,
                                    cfg.resolved_head_dim, 2, True,
                                    cfg.sliding_window)
    assert cost.kernel_calls == {"flash_attention": cfg.num_layers}
    assert cost.by_opcode_bytes["flash_attention"] == cfg.num_layers * nbytes
    monkeypatch.setattr(attention, "flash_attention_op",
                        lambda *a, **k: flash_attention_op(*a, **k,
                                                           impl="ref"))
    plain = plan()
    assert plain.kernel_calls == {}
    scores = b * cfg.num_heads * s * s * 4
    assert plain.hbm_bytes - cost.hbm_bytes > cfg.num_layers * scores


def test_report_tables_fit_80g():
    from repro_torch.roofline.report import dryrun_table, perf_table
    roof = {"t_compute": 1e-3, "t_memory": 2.0, "t_collective": 0.0,
            "bottleneck": "memory", "roofline_fraction": 0.0005,
            "useful_flops_ratio": 0.5, "peak_mem_bytes": 90 * 2**30,
            "arg_bytes": 3 * 2**30}
    recs = [{"arch": "a", "shape": "s", "mesh": "16x16", "status": "ok",
             "fits_hbm": False, "roofline": roof, "tag": "v"},
            {"arch": "b", "shape": "s", "mesh": "16x16",
             "status": "skipped"},
            {"arch": "c", "shape": "s", "mesh": "2x16x16", "status": "ok",
             "fits_hbm": True, "roofline": roof}]
    table = dryrun_table(recs, "16x16").splitlines()
    assert "fits 80G" in table[0] and len(table) == 4
    assert table[2] == ("| a | s | 1.0ms | 2.00s | 0 | memory | 0.001 | "
                        "0.50 | 90.0 | 3.0 | no |")
    assert "skipped" in table[3]
    assert "**v**" in perf_table(recs[:1])
