"""repro_torch.optim against the JAX package's optimizer, on the CPU.

The cases of tests/test_optim.py, run as `repro` against `repro_torch` on
the same numpy inputs: the blockwise int8 quantizer (bit for bit: the
same fp32 arithmetic, round half to even on both sides) and the log-domain
one (the libraries' fp32 log may round an ulp apart: block bounds at rtol
1e-6, codes within one step, values within one step's factor),
AdamW for 1 and 3 steps with fp32, bf16 and int8 state, the grad clip,
the decay rule, the int8 state's memory, and warmup_cosine at every step
(rtol 1e-6, and atol 1e-6 of the peak rate: near the end of the cosine
1 + cos cancels, and the libraries' cos may differ by an ulp).
Tolerances: params and dense moments at rtol 1e-6, atol 1e-7 (fp32,
where the two packages may round a division or sqrt 1 ulp apart), int8
moments compared dequantized at one quantization step of their block.
"""
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import TrainConfig as RefTrainConfig  # noqa: E402
from repro.optim import adamw as ref_adamw  # noqa: E402
from repro.optim import quant as ref_quant  # noqa: E402
from repro.optim.schedules import warmup_cosine as ref_warmup  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.models.common import tree_leaves, tree_map  # noqa: E402
from repro_torch.optim.adamw import adamw_init, adamw_update  # noqa: E402
from repro_torch.optim.quant import (LogQTensor, QTensor,  # noqa: E402
                                     dequantize, dequantize_log, quantize,
                                     quantize_log)
from repro_torch.optim.schedules import warmup_cosine  # noqa: E402


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x, np.float32) if x.dtype == jnp.bfloat16 \
        else np.asarray(x)


# -- quantization --------------------------------------------------------------
@settings(max_examples=25, deadline=None)
@given(n=st.integers(1, 2000),
       scale=st.sampled_from([1e-6, 1e-2, 1.0, 1e3]),
       block=st.sampled_from([32, 256]))
def test_quantize_roundtrip_matches_reference(n, scale, block):
    x = scale * np.random.default_rng(n).normal(size=(n,)).astype(np.float32)
    q = quantize(torch.from_numpy(x), block)
    rq = ref_quant.quantize(jnp.asarray(x), block)
    np.testing.assert_array_equal(q.data.numpy(), np.asarray(rq.data))
    np.testing.assert_array_equal(q.scale.numpy(), np.asarray(rq.scale))
    back = dequantize(q).numpy()
    assert back.shape == x.shape
    np.testing.assert_array_equal(back, np.asarray(ref_quant.dequantize(rq)))
    # symmetric int8: error bounded by scale/127 per block (= max|block|/127)
    bound = np.abs(x).max() / 127 + 1e-12
    assert np.max(np.abs(back - x)) <= bound * 1.0001


@settings(max_examples=25, deadline=None)
@given(n=st.integers(1, 2000), block=st.sampled_from([32, 256]),
       zeros=st.booleans())
def test_quantize_log_roundtrip_matches_reference(n, block, zeros):
    rng = np.random.default_rng(n)
    x = np.exp(rng.normal(0, 8, size=(n,))).astype(np.float32)
    if zeros:
        x[::3] = 0.0
    q = quantize_log(torch.from_numpy(x), block)
    rq = ref_quant.quantize_log(jnp.asarray(x), block)
    # the libraries' fp32 log may round 1 ulp apart: lo/hi at rtol 1e-6, a
    # code at most one step away, the values within one step's factor
    for got, want in ((q.lo, rq.lo), (q.hi, rq.hi)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    codes = q.data.numpy().astype(np.int32) - np.asarray(rq.data, np.int32)
    assert np.abs(codes).max() <= 1
    got = dequantize_log(q).numpy()
    want = np.asarray(ref_quant.dequantize_log(rq))
    np.testing.assert_array_equal(got == 0, want == 0)
    span = np.repeat(np.asarray(rq.hi - rq.lo)[:, 0], block)[:n]
    nz = want != 0
    assert np.all(np.abs(np.log(got[nz]) - np.log(want[nz]))
                  <= span[nz] / 254 + 1e-5)


def test_quantized_tensors_are_tree_nodes_in_the_reference_order():
    x = torch.arange(300, dtype=torch.float32).reshape(10, 30)
    q = quantize(x)
    assert isinstance(q, QTensor) and q.shape == (10, 30)
    assert [t is u for t, u in zip(tree_leaves(q), (q.data, q.scale))] == [
        True, True]
    lq = quantize_log(x)
    assert tree_leaves(lq) == [lq.data, lq.lo, lq.hi]
    doubled = tree_map(lambda t: t.clone(), {"m": q, "v": lq})
    assert isinstance(doubled["m"], QTensor) and doubled["m"].shape == (10, 30)
    assert isinstance(doubled["v"], LogQTensor)
    np.testing.assert_allclose(dequantize(doubled["m"]).numpy(), x.numpy(),
                               atol=float(x.max()) / 127 * 1.01)


# -- AdamW ----------------------------------------------------------------------
def _problem(seed=0):
    """Params: a matrix, a stacked (L, d) norm-like leaf and a vector;
    grads for 3 steps (the last large enough to clip)."""
    rng = np.random.default_rng(seed)
    params = {"w": rng.normal(size=(16, 300)).astype(np.float32),
              "norms": (1 + 0.1 * rng.normal(size=(3, 40))).astype(np.float32),
              "b": rng.normal(size=(7,)).astype(np.float32)}
    grads = [{k: (s * rng.normal(size=v.shape)).astype(np.float32)
              for k, v in params.items()} for s in (0.01, 0.1, 5.0)]
    return params, grads


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16", "int8"])
def test_adamw_matches_reference(state_dtype, steps):
    params, grads = _problem()
    cfg = dict(learning_rate=1e-2, weight_decay=0.1, grad_clip=1.0)
    rcfg, tcfg = RefTrainConfig(**cfg), TrainConfig(**cfg)
    pdt = jnp.bfloat16 if state_dtype == "bfloat16" else jnp.float32
    rp = {k: jnp.asarray(v).astype(pdt) for k, v in params.items()}
    tp = {k: torch.from_numpy(v).to(getattr(torch, str(np.dtype(pdt))))
          for k, v in params.items()}
    ro, to = (ref_adamw.adamw_init(rp, state_dtype),
              adamw_init(tp, state_dtype))
    for i in range(steps):
        lr = 1e-2 * (i + 1)
        rp, ro, rg = ref_adamw.adamw_update(
            {k: jnp.asarray(v) for k, v in grads[i].items()}, ro, rp,
            jnp.float32(lr), rcfg, state_dtype)
        tp, to, tg = adamw_update(
            {k: torch.from_numpy(v) for k, v in grads[i].items()}, to, tp,
            torch.tensor(lr, dtype=torch.float32), tcfg, state_dtype)
        np.testing.assert_allclose(float(tg), float(rg), rtol=1e-6)
    assert int(to.count) == int(ro.count) == steps
    for k in params:
        np.testing.assert_allclose(_np(tp[k]), _np(rp[k]), rtol=1e-6,
                                   atol=1e-7)
        for got, want in ((to.m[k], ro.m[k]), (to.v[k], ro.v[k])):
            if state_dtype == "int8":
                # a 1-ulp input difference may move a value by one step
                deq = dequantize if isinstance(got, QTensor) else \
                    dequantize_log
                rdeq = ref_quant.dequantize if isinstance(got, QTensor) \
                    else ref_quant.dequantize_log
                g, w = deq(got).numpy(), np.asarray(rdeq(want))
                step = np.abs(w).max() / 127 if isinstance(got, QTensor) \
                    else np.abs(w).max() * 0.1
                np.testing.assert_allclose(g, w, atol=step, rtol=0.1)
            else:
                np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6,
                                           atol=1e-7)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16", "int8"])
def test_adamw_converges_quadratic(state_dtype):
    """min ||w - target||^2 -- every state dtype must converge."""
    target = torch.from_numpy(
        np.random.default_rng(0).normal(size=(16, 16)).astype(np.float32))
    params = {"w": torch.zeros((16, 16))}
    cfg = TrainConfig(learning_rate=0.1, weight_decay=0.0, grad_clip=0.0)
    opt = adamw_init(params, state_dtype)
    lr = torch.tensor(0.05)
    for _ in range(120):
        grads = {"w": 2 * (params["w"] - target)}
        params, opt, _ = adamw_update(grads, opt, params, lr, cfg,
                                      state_dtype)
    err = float((params["w"] - target).abs().max())
    assert err < 0.05, (state_dtype, err)


def test_adamw_grad_clip_caps_update():
    params = {"w": torch.zeros(4)}
    cfg = TrainConfig(learning_rate=1.0, grad_clip=1.0, weight_decay=0.0)
    opt = adamw_init(params)
    _, _, gnorm = adamw_update({"w": torch.full((4,), 100.0)}, opt, params,
                               torch.tensor(1.0), cfg)
    assert float(gnorm) == pytest.approx(200.0)


def test_adamw_weight_decay_on_every_leaf_of_two_or_more_dims():
    """No decay on a vector; decay on a matrix, and on a stacked (L, d)
    leaf such as a layer stack's norm weights (the reference's rule)."""
    cfg = TrainConfig(learning_rate=0.1, weight_decay=1.0, grad_clip=0.0)
    params = {"w": torch.ones(4, 4), "b": torch.ones(4),
              "norms": torch.ones(2, 4)}
    opt = adamw_init(params)
    zero_g = {k: torch.zeros_like(v) for k, v in params.items()}
    new_p, _, _ = adamw_update(zero_g, opt, params, torch.tensor(0.1), cfg)
    assert float((new_p["b"] - 1.0).abs().max()) < 1e-6      # no decay
    assert float(new_p["w"].max()) < 1.0                     # decayed
    assert float(new_p["norms"].max()) < 1.0                 # decayed too
    rp = {k: jnp.ones(v.shape) for k, v in params.items()}
    rnew, _, _ = ref_adamw.adamw_update(
        jax.tree.map(jnp.zeros_like, rp), ref_adamw.adamw_init(rp), rp, 0.1,
        RefTrainConfig(learning_rate=0.1, weight_decay=1.0, grad_clip=0.0))
    for k in params:
        np.testing.assert_allclose(new_p[k].numpy(), np.asarray(rnew[k]),
                                   rtol=1e-6)


def test_int8_opt_state_memory_is_quarter():
    params = {"w": torch.zeros((1024, 256))}
    o32 = adamw_init(params, "float32")
    o8 = adamw_init(params, "int8")
    b32 = o32.m["w"].nbytes
    b8 = o8.m["w"].data.nbytes + o8.m["w"].scale.nbytes
    assert b8 < 0.30 * b32


def test_warmup_cosine_matches_reference_at_every_step():
    for warm, total in ((10, 60), (1, 3), (100, 1000)):
        kw = dict(learning_rate=3e-4, warmup_steps=warm, total_steps=total)
        rcfg, tcfg = RefTrainConfig(**kw), TrainConfig(**kw)
        steps = np.arange(total + 5, dtype=np.int32)
        got = warmup_cosine(torch.from_numpy(steps), tcfg).numpy()
        want = np.asarray(ref_warmup(jnp.asarray(steps), rcfg))
        np.testing.assert_allclose(got, want, rtol=1e-6,
                                   atol=1e-6 * kw["learning_rate"])
