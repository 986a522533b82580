"""repro_torch.models.moe against repro.models.moe, on the CPU.

The JAX package's MoE params (``init_params`` over ``moe_specs``) are
carried into the port with ``carry.params_from_numpy``; the same numpy
activations go through both.  Configs: the MoE FFN of
``reduced(mixtral_8x22b)`` (4 experts top-2, softmax router, Switch aux
loss) and of ``reduced(deepseek_v3_671b)`` (4 routed experts top-2 and a
shared one, sigmoid router with the aux-free bias and router_scale 2.5).
Tolerances: fp32 (leaves and activations fp32 on both sides) atol 1e-5;
bf16 atol 1e-2; for the FFN's output both of the output's largest
magnitude (see ``_close``).  Expert choices and dropped tokens must be the same
exactly: a capacity factor of 1.25 drops tokens, and the port must drop
the same ones.  The last tests are the cases of tests/test_moe.py, run on
the port.
"""
import dataclasses

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs.base import reduced as ref_reduced  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.models.common import init_params as ref_init  # noqa: E402
from repro_torch.carry import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import reduced  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.common import init_params  # noqa: E402

ARCHS = ("mixtral_8x22b", "deepseek_v3_671b")


def _cfgs(arch, **moe_over):
    """The reduced config of `arch` in both packages, MoE part replaced."""
    r = ref_reduced(ref_get_config(arch))
    p = reduced(get_config(arch))
    r = dataclasses.replace(r, moe=dataclasses.replace(r.moe, **moe_over))
    p = dataclasses.replace(p, moe=dataclasses.replace(p.moe, **moe_over))
    return r, p


def _params(rcfg, dtype, bias_seed=None):
    """The JAX MoE params (fp32 leaves for fp32) and the port's copy.  With
    `bias_seed`, the aux-free router bias is drawn instead of zeros, so
    that it moves the selection."""
    jp = ref_init(jax.random.key(0), ref_moe.moe_specs(rcfg))
    if dtype == "float32":
        jp = jax.tree.map(lambda x: x.astype(jnp.float32), jp)
    if bias_seed is not None:
        jp["router_bias"] = jnp.asarray(np.random.default_rng(
            bias_seed).normal(0, 0.5, jp["router_bias"].shape), jnp.float32)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _x(shape, dtype, seed):
    """Activations of unit scale with a direction all tokens share, as
    correlated tokens have: it skews the routing toward some experts, so
    that a capacity factor of 1.25 drops tokens."""
    rng = np.random.default_rng(seed)
    a = (0.6 * rng.standard_normal(shape)
         + rng.standard_normal(shape[-1])).astype(np.float32)
    jx = jnp.asarray(a).astype(jnp.bfloat16 if dtype == "bfloat16"
                                else jnp.float32)
    return jx, torch.from_numpy(a).to(getattr(torch, dtype))


def _close(got, want, dtype):
    """atol 1e-5 (fp32) or 1e-2 (bf16) of the output's largest magnitude:
    the reference's `scaled` init takes the expert count as fan-in, so the
    outputs reach ~100, where fp32's own spacing is 8e-6 and bf16's 0.5."""
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=(1e-5 if dtype == "float32" else 1e-2)
                               * scale, rtol=0)


# -- parity with the JAX package ---------------------------------------------
@settings(max_examples=25, deadline=None)
@given(g=st.integers(1, 4), t=st.integers(1, 160), e=st.integers(1, 16),
       seed=st.integers(0, 1000))
def test_positions_in_expert_equal_the_reference(g, t, e, seed):
    flat = np.random.default_rng(seed).integers(0, e, size=(g, t))
    want = np.asarray(ref_moe._positions_in_expert(
        jnp.asarray(flat, jnp.int32)))
    got = moe._positions_in_expert(torch.from_numpy(flat))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_route_matches_the_reference(arch, dtype):
    """Weights, expert ids (exact) and aux loss; DeepSeek's with a drawn
    bias that changes the selection but not the weights' source."""
    rcfg, pcfg = _cfgs(arch)
    jp, tp = _params(rcfg, dtype, bias_seed=5 if arch != ARCHS[0] else None)
    jx, tx = _x((3, 24, rcfg.d_model), dtype, seed=1)
    w, idx, aux = ref_moe._route(jp, jx, rcfg.moe)
    tw, tidx, taux = moe._route(tp, tx, pcfg.moe)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(idx))
    np.testing.assert_allclose(tw.numpy(), np.asarray(w), atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(taux), float(aux), atol=1e-5)
    if arch == "deepseek_v3_671b":
        np.testing.assert_allclose(tw.sum(-1).numpy(), 2.5, atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_route_breaks_ties_toward_the_lower_expert(arch):
    """A zero router scores every expert alike: the reference's top_k
    takes experts 0 and 1, and so must the port."""
    rcfg, pcfg = _cfgs(arch)
    jp, tp = _params(rcfg, "float32")
    jp["router"] = jnp.zeros_like(jp["router"])
    tp["router"] = torch.zeros_like(tp["router"])
    jx, tx = _x((2, 5, rcfg.d_model), "float32", seed=2)
    _, idx, _ = ref_moe._route(jp, jx, rcfg.moe)
    _, tidx, _ = moe._route(tp, tx, pcfg.moe)
    assert np.asarray(idx).reshape(-1, 2).tolist() == [[0, 1]] * 10
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(idx))


# (arch, capacity factor, x shape): drops at 1.25 with whole rows of 40
# tokens as groups; none at 8; decode (B=8, S=1) regrouped into fuller
# groups; DeepSeek's shared expert beside the routed ones
FFN_CASES = {
    "cf1.25 drops": ("mixtral_8x22b", 1.25, (2, 40)),
    "cf8": ("mixtral_8x22b", 8.0, (2, 40)),
    "decode regroup": ("mixtral_8x22b", 1.25, (8, 1)),
    "shared expert": ("deepseek_v3_671b", 1.25, (2, 40)),
}


def _dropped(pcfg, tp, tx):
    """Tokens past capacity in the port's dispatch of `tx`."""
    _, idx, _ = moe._route(tp, tx, pcfg.moe)
    b, s = tx.shape[:2]
    k, ne = pcfg.moe.top_k, pcfg.moe.num_experts
    if s * k < ne and b > 1:               # the decode regrouping
        tpg = max(1, 2 * ne // k)
        g = max(1, (b * s) // tpg)
        while (b * s) % g:
            g -= 1
        b, s = g, b * s // g
    cap = max(1, int(pcfg.moe.capacity_factor * s * k / ne))
    pos = moe._positions_in_expert(idx.reshape(b, s * k))
    return int((pos >= cap).sum())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(FFN_CASES))
def test_moe_ffn_matches_the_reference(case, dtype):
    arch, cf, (b, s) = FFN_CASES[case]
    rcfg, pcfg = _cfgs(arch, capacity_factor=cf)
    jp, tp = _params(rcfg, dtype, bias_seed=7 if arch != ARCHS[0] else None)
    jx, tx = _x((b, s, rcfg.d_model), dtype, seed=3)
    want, aux = ref_moe.moe_ffn(jp, jx, rcfg)
    got, taux = moe.moe_ffn(tp, tx, pcfg)
    assert got.dtype == tx.dtype and tuple(got.shape) == (b, s, rcfg.d_model)
    _close(got, want, dtype)
    np.testing.assert_allclose(float(taux), float(aux), atol=1e-5)
    drops = _dropped(pcfg, tp, tx)
    if case in ("cf1.25 drops", "decode regroup"):
        assert drops > 0, "the case must drop tokens"
    if case == "cf8":
        assert drops == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_router_load_matches_the_reference(arch):
    rcfg, pcfg = _cfgs(arch)
    jp, tp = _params(rcfg, "bfloat16", bias_seed=9 if arch != ARCHS[0]
                     else None)
    jx, tx = _x((2, 64, rcfg.d_model), "bfloat16", seed=4)
    want = np.asarray(ref_moe.router_load(jp, jx, rcfg))
    got = moe.router_load(tp, tx, pcfg)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.sum()) == 2 * 64 * pcfg.moe.top_k


def test_moe_specs_match_the_reference():
    for arch in ARCHS:
        rcfg, pcfg = _cfgs(arch)
        want = ref_moe.moe_specs(rcfg)
        got = moe.moe_specs(pcfg)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].shape == want[k].shape
            assert got[k].logical == want[k].logical
            assert got[k].init == want[k].init
            assert str(got[k].dtype).split(".")[-1] == \
                jnp.dtype(want[k].dtype).name


# -- the cases of tests/test_moe.py, on the port -------------------------------
def _moe_cfg(cf=8.0, experts=4, top_k=2):
    cfg = reduced(get_config("mixtral_8x22b"))
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf, num_experts=experts, top_k=top_k))


def _init(cfg, seed=0):
    return init_params(moe.moe_specs(cfg), torch.Generator().manual_seed(
        seed), torch.device("cpu"))


def _randn(shape, seed=1):
    return torch.randn(shape, generator=torch.Generator().manual_seed(
        seed)).to(torch.bfloat16)


@settings(max_examples=20, deadline=None)
@given(g=st.integers(1, 4), t=st.integers(1, 128), e=st.integers(1, 16),
       seed=st.integers(0, 100))
def test_positions_in_expert_is_occurrence_rank(g, t, e, seed):
    flat = torch.from_numpy(np.random.default_rng(seed).integers(
        0, e, size=(g, t)))
    pos = moe._positions_in_expert(flat).numpy()
    for gi in range(g):
        seen = {}
        for ti in range(t):
            eid = int(flat[gi, ti])
            assert pos[gi, ti] == seen.get(eid, 0)
            seen[eid] = seen.get(eid, 0) + 1


def test_moe_capacity_drops_tokens():
    """cf -> 0 forces drops; output rows for dropped tokens shrink toward
    the shared-expert-only value (here: zero)."""
    cfg_hi = _moe_cfg(cf=8.0)
    cfg_lo = dataclasses.replace(cfg_hi, moe=dataclasses.replace(
        cfg_hi.moe, capacity_factor=0.05))
    params = _init(cfg_hi)
    x = _randn((2, 32, cfg_hi.d_model))
    y_hi, _ = moe.moe_ffn(params, x, cfg_hi)
    y_lo, _ = moe.moe_ffn(params, x, cfg_lo)
    assert float(y_lo.float().norm()) < float(y_hi.float().norm())


def test_moe_grouping_matches_ungrouped():
    """Decode regrouping (s*k < E) must not change results when capacity is
    ample: same tokens, same experts, different group partitioning."""
    cfg = _moe_cfg(cf=32.0, experts=16, top_k=2)
    params = _init(cfg)
    xb = _randn((8, 1, cfg.d_model))
    y_dec, _ = moe.moe_ffn(params, xb, cfg)          # s*k=2 < 16: regroups
    y_ref, _ = moe.moe_ffn(params, xb.reshape(1, 8, cfg.d_model), cfg)
    np.testing.assert_allclose(y_dec.reshape(1, 8, -1).float().numpy(),
                               y_ref.float().numpy(), atol=1e-2, rtol=1e-2)


def test_router_weights_normalized():
    cfg = _moe_cfg()
    params = _init(cfg)
    x = _randn((2, 16, cfg.d_model))
    w, idx, aux = moe._route(params, x, cfg.moe)
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, atol=1e-5)
    assert int(idx.max()) < cfg.moe.num_experts
    assert float(aux) >= 0.0


def test_aux_free_router_bias_shifts_selection():
    """DeepSeek aux-free balancing: raising one expert's bias attracts
    load; the bias changes the selection only, not the weights."""
    cfg = reduced(get_config("deepseek_v3_671b"))
    params = _init(cfg)
    x = _randn((2, 64, cfg.d_model))
    load0 = moe.router_load(params, x, cfg).numpy()
    params2 = dict(params)
    params2["router_bias"] = params["router_bias"].clone()
    params2["router_bias"][0] = 10.0
    load1 = moe.router_load(params2, x, cfg).numpy()
    assert load1[0] > load0[0]
    w, idx, _ = moe._route(params2, x, cfg.moe)
    assert float(w.min()) >= 0.0
