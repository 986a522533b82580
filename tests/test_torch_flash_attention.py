"""repro_torch.kernels.flash_attention against the JAX package's kernel.

The same numpy inputs go through the port's plain version (ref.py), the
JAX oracle and the JAX Pallas kernel in interpret mode (as
tests/test_kernels.py runs it on the CPU), over the grid of
test_kernels.py (S, heads, H, causal, window), plus G = 5 query heads per
kv head (Hymba's 25/5), ragged S, which only the oracle takes (the
Pallas kernel needs S divisible by its block), and non-causal Sq != Skv
(Whisper's cross attention).  Tolerances: atol/rtol 2e-5
in fp32 and 2e-2 in bf16, as test_kernels.py.  The plain attention with P
rounded to bf16 before P.V, as the tensor-core kernel rounds it, is held to
the fp32 plain result at the bf16 tolerance here, and the tensor-core
kernel to it on the card within 2 bf16 ulps + 1e-3.  The CUDA kernels
themselves run only on a card (bf16 on the tensor cores, fp32 on the CUDA
cores): the `gpu` tests import nothing of JAX, so they also run where JAX
is absent (``pytest --noconftest -m gpu``).
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import \
    flash_attention as cuda_mod  # noqa: E402
from repro_torch.kernels.flash_attention.ops import \
    flash_attention_op  # noqa: E402
from repro_torch.kernels.flash_attention.ref import \
    flash_attention_ref  # noqa: E402

GRID = list(itertools.product([128, 384], [(4, 2), (4, 4), (6, 3)], [32, 64],
                              [True, False], [0, 64]))
BF16_GRID = [g for g in GRID if g[0] == 128 and g[2] == 64 and g[3]]
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(b, sq, nq, nkv, h, seed=0, skv=None):
    rng = np.random.default_rng(seed)
    skv = sq if skv is None else skv
    return (rng.standard_normal((b, sq, nq, h)).astype(np.float32),
            rng.standard_normal((b, skv, nkv, h)).astype(np.float32),
            rng.standard_normal((b, skv, nkv, h)).astype(np.float32))


def _port(args, dtype="float32", causal=True, window=0, device="cpu",
          impl="ref"):
    q, k, v = (torch.from_numpy(x).to(device, _TORCH[dtype]) for x in args)
    return flash_attention_op(q, k, v, causal=causal, window=window,
                              impl=impl)


def _jax(args, dtype="float32", causal=True, window=0, kernel=True):
    """The JAX oracle and, with `kernel`, the Pallas kernel in interpret
    mode (blocks of 64 rows) on the same data."""
    import jax.numpy as jnp
    from repro.kernels.flash_attention.flash_attention import \
        flash_attention
    from repro.kernels.flash_attention.ref import \
        flash_attention_ref as jax_ref
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    q, k, v = (jnp.asarray(x, jdt) for x in args)
    outs = [jax_ref(q, k, v, causal=causal, window=window)]
    if kernel:
        outs.append(flash_attention(q, k, v, causal=causal, window=window,
                                    block_q=64, block_k=64, interpret=True))
    return [np.asarray(o, np.float32) for o in outs]


@pytest.mark.parametrize("sq,heads,h,causal,window", GRID)
def test_port_ref_matches_jax_ref_and_kernel_fp32(sq, heads, h, causal,
                                                   window):
    args = _inputs(2, sq, *heads, h)
    ours = _port(args, causal=causal, window=window).numpy()
    for want in _jax(args, causal=causal, window=window):
        np.testing.assert_allclose(ours, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("sq,heads,h,causal,window", BF16_GRID)
def test_port_ref_matches_jax_ref_and_kernel_bf16(sq, heads, h, causal,
                                                   window):
    args = _inputs(2, sq, *heads, h, seed=1)
    ours = _port(args, "bfloat16", causal=causal, window=window)
    assert ours.dtype == torch.bfloat16
    for want in _jax(args, "bfloat16", causal=causal, window=window):
        np.testing.assert_allclose(ours.float().numpy(), want, atol=2e-2,
                                   rtol=2e-2)


@pytest.mark.parametrize("heads,window", [((10, 2), 0), ((10, 2), 64),
                                          ((25, 5), 96)])
def test_five_query_heads_per_kv_head(heads, window):
    """G = 5, Hymba's grouping (25 query over 5 kv heads)."""
    args = _inputs(1, 192, *heads, 64, seed=2)
    ours = _port(args, window=window).numpy()
    for want in _jax(args, window=window):
        np.testing.assert_allclose(ours, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("sq,heads,h,window", [(100, (6, 3), 32, 0),
                                               (333, (10, 2), 64, 64),
                                               (1000, (6, 3), 32, 256)])
def test_ragged_sequence_matches_jax_ref(sq, heads, h, window):
    args = _inputs(2, sq, *heads, h, seed=3)
    ours = _port(args, window=window).numpy()
    (want,) = _jax(args, window=window, kernel=False)
    np.testing.assert_allclose(ours, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("sq,skv,heads", [(64, 192, (8, 8)),
                                           (1, 192, (8, 8)),
                                           (128, 64, (4, 2))])
def test_cross_shapes_match_jax_ref_and_kernel(sq, skv, heads):
    """Non-causal attention with Sq != Skv, as Whisper's cross attention
    runs it: the prompt's queries (or one decode token's) against all the
    encoder's frames, fp32 and bf16."""
    args = _inputs(2, sq, *heads, 64, seed=4, skv=skv)
    ours = _port(args, causal=False).numpy()
    assert ours.shape == (2, sq, heads[0], 64)
    for want in _jax(args, causal=False):
        np.testing.assert_allclose(ours, want, atol=2e-5, rtol=2e-5)
    ours = _port(args, "bfloat16", causal=False).float().numpy()
    for want in _jax(args, "bfloat16", causal=False):
        np.testing.assert_allclose(ours, want, atol=2e-2, rtol=2e-2)


def test_causality():
    """Perturbing a future token must not change past outputs."""
    q, k, v = _inputs(1, 256, 4, 2, 32, seed=4)
    o1 = _port((q, k, v)).numpy()
    k2, v2 = k.copy(), v.copy()
    k2[0, -1] += 10.0
    v2[0, -1] += 10.0
    o2 = _port((q, k2, v2)).numpy()
    np.testing.assert_allclose(o1[:, :-1], o2[:, :-1], atol=1e-6)


def test_window_drops_what_lies_behind_it():
    """With a window of w, a kv row w or more behind the query row must not
    change its output."""
    q, k, v = _inputs(1, 128, 4, 2, 32, seed=5)
    o1 = _port((q, k, v), window=16).numpy()
    k2, v2 = k.copy(), v.copy()
    k2[0, :40] += 10.0
    v2[0, :40] += 10.0
    o2 = _port((q, k2, v2), window=16).numpy()
    np.testing.assert_allclose(o1[:, 56:], o2[:, 56:], atol=1e-6)
    assert not np.allclose(o1[:, 40:55], o2[:, 40:55])


def _launches():
    return cuda_mod.LAUNCHES, cuda_mod.TC_LAUNCHES


def test_auto_on_cpu_runs_the_plain_version_and_launches_nothing():
    args = _inputs(2, 64, 8, 2, 32, seed=6)
    before = _launches()
    got = _port(args, impl="auto", window=16)
    assert _launches() == before
    assert torch.equal(got, _port(args, impl="ref", window=16))


@pytest.mark.parametrize("impl", ["cuda", "bogus"])
def test_cuda_or_unknown_impl_on_a_cpu_tensor_raises(impl):
    args = _inputs(1, 32, 4, 2, 16, seed=7)
    before = _launches()
    with pytest.raises(ValueError):
        _port(args, impl=impl)
    assert _launches() == before


def _rounded_p_attention(q, k, v, causal=True, window=0, block=64):
    """The plain attention as the tensor-core kernel rounds it: fp32 scores,
    an online softmax over kv tiles of `block` rows taken in order, each
    tile's weights exp(s - running max) rounded to bf16 before P.V, the row
    sums taken over the unrounded weights; a row with no valid kv row gets
    0; output in bf16.  Runs on the inputs' device."""
    b, sq, nq, h = q.shape
    skv, nkv = k.shape[1], k.shape[2]
    dev = q.device
    qg = q.float().reshape(b, sq, nkv, nq // nkv, h)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * (h ** -0.5)
    rel = (torch.arange(sq, device=dev)[:, None]
           - torch.arange(skv, device=dev)[None, :])
    mask = torch.ones((sq, skv), dtype=torch.bool, device=dev)
    if causal:
        mask &= rel >= 0
    if window:
        mask &= rel < window
    s = torch.where(mask, s, float("-inf"))
    m = torch.full(s.shape[:-1], float("-inf"), device=dev)
    l = torch.zeros_like(m)
    o = torch.zeros(s.shape[:-1] + (h,), device=dev)
    for k0 in range(0, skv, block):
        m_new = torch.maximum(m, s[..., k0:k0 + block].amax(-1))
        mu = torch.where(m_new == float("-inf"), 0.0, m_new)
        corr = torch.exp(m - mu)
        p = torch.exp(s[..., k0:k0 + block] - mu[..., None])
        l = l * corr + p.sum(-1)
        o = o * corr[..., None] + torch.einsum(
            "bkgqs,bskd->bkgqd", p.bfloat16().float(),
            v[:, k0:k0 + block].float())
        m = m_new
    o = torch.where(l[..., None] > 0, o / l.clamp_min(1e-30)[..., None], 0.0)
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, nq, h).bfloat16()


def _bf16_ulp(x):
    """The spacing of bf16 values at |x| (8 significant bits); 0 at 0."""
    x = x.float()
    _, e = torch.frexp(x)
    return torch.where(x == 0, 0.0, torch.ldexp(torch.ones_like(x), e - 8))


@pytest.mark.parametrize("sq,window,seed", [(192, 96, 10), (256, 64, 11),
                                            (130, 100, 12), (128, 0, 13)])
def test_bf16_p_rounding_stays_inside_the_bf16_tolerance(sq, window, seed):
    """Rounding P to bf16 before P.V (the tensor-core kernel's A operand)
    keeps the result within the card test's 2e-2 of the fp32 plain result
    cast to bf16, at Hymba-like widths (25/5 heads, H=64, window below S)."""
    q, k, v = (torch.from_numpy(x).bfloat16()
               for x in _inputs(1, sq, 25, 5, 64, seed=seed))
    got = _rounded_p_attention(q, k, v, window=window).float()
    want = flash_attention_ref(q.float(), k.float(), v.float(),
                               window=window).bfloat16().float()
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-2,
                               rtol=2e-2)
    assert not torch.equal(got, want)     # the rounding does show


# -- on the card -----------------------------------------------------------
CARD = [((1, 2048, 25, 5, 64), "bfloat16", True, 1024),
        ((8, 512, 25, 5, 64), "bfloat16", True, 1024),
        ((8, 128, 32, 8, 64), "bfloat16", True, 0),
        ((2, 384, 36, 4, 128), "bfloat16", True, 0),      # StarCoder2-7B
        ((1, 4608, 48, 8, 128), "bfloat16", True, 4096),  # Mixtral refill
        ((2, 256, 8, 2, 32), "bfloat16", True, 0),
        ((2, 1000, 6, 3, 64), "bfloat16", True, 100),
        ((2, 300, 8, 8, 64), "bfloat16", True, 0),        # G = 1
        ((2, 200, 4, 2, 64), "bfloat16", False, 0),
        ((4, 1, 8, 2, 64), "bfloat16", True, 0),          # Sq = 1
        ((2, 200, 4, 4, 20), "bfloat16", False, 0),       # rows of 40 bytes
        ((1, 130, 4, 2, 100), "bfloat16", False, 48),
        ((3, 1000, 6, 3, 32), "float32", True, 0),
        ((2, 333, 10, 2, 64), "float32", True, 100),
        ((2, 200, 4, 4, 20), "float32", False, 0),
        ((1, 130, 4, 2, 128), "float32", False, 48)]


# Whisper-base's shapes, non-causal, at reduced batch: the encoder (1500
# frames), cross attention of a 64-token prompt and of one decode token
# against the 1500 frames (8/8 heads of 64)
CROSS_CARD = [((2, 1500, 8, 8, 64), 1500), ((2, 64, 8, 8, 64), 1500),
              ((8, 1, 8, 8, 64), 1500)]


# the tensor-core kernel against `_rounded_p_attention`: the output's own
# bf16 rounding can differ by one ulp, and a bf16 weight can round the other
# way where the fp32 scores differ in their last bits, which moves a row of
# few valid kv rows by up to 2^-8 of a weighted v; 1e-3 is 20x tighter
# than the 2e-2 against the fp32 plain result
TC_ULPS, TC_ATOL = 2, 1e-3


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype,causal,window", CARD)
def test_cuda_kernel_matches_plain_version_on_the_card(shape, dtype, causal,
                                                       window):
    _card()
    args = _inputs(*shape, seed=8)
    cores, tensor_cores = _launches()
    got = _port(args, dtype, causal=causal, window=window, device="cuda",
                impl="auto")
    torch.cuda.synchronize()
    # bf16 on the tensor cores, fp32 on the CUDA cores
    tc = dtype == "bfloat16"
    assert _launches() == (cores + (not tc), tensor_cores + tc)
    # the plain version in fp32 on the same (dtype-rounded) inputs
    rounded = [torch.from_numpy(x).to(_TORCH[dtype]).float() for x in args]
    want = flash_attention_ref(*rounded, causal=causal, window=window)
    tol = 2e-5 if dtype == "float32" else 2e-2
    want = want.to(_TORCH[dtype]).float()
    np.testing.assert_allclose(got.float().cpu().numpy(), want.numpy(),
                               atol=tol, rtol=tol)
    if tc:
        # the tensor-core kernel's own rounding, to a few bf16 ulps: a mask
        # or fragment-layout fault shows here where 2e-2 would pass it
        qd, kd, vd = (t.to("cuda", torch.bfloat16) for t in rounded)
        close = _rounded_p_attention(qd, kd, vd, causal=causal,
                                     window=window).float()
        err = (got.float() - close).abs()
        limit = TC_ULPS * _bf16_ulp(close) + TC_ATOL
        assert bool((err <= limit).all()), (
            f"max |err| {float(err.max())}, "
            f"max err/limit {float((err / limit).max())}")


@pytest.mark.gpu
@pytest.mark.parametrize("shape,skv", CROSS_CARD)
def test_cuda_kernel_whisper_shapes_on_the_card(shape, skv):
    """Non-causal with Sq != Skv on the tensor-core kernel: against the
    fp32 plain result at 2e-2 and against its own rounding
    (`_rounded_p_attention`) within TC_ULPS bf16 ulps + TC_ATOL."""
    _card()
    args = _inputs(*shape, seed=9, skv=skv)
    cores, tensor_cores = _launches()
    got = _port(args, "bfloat16", causal=False, device="cuda", impl="auto")
    torch.cuda.synchronize()
    assert _launches() == (cores, tensor_cores + 1)
    rounded = [torch.from_numpy(x).bfloat16().float() for x in args]
    want = flash_attention_ref(*rounded, causal=False).bfloat16().float()
    np.testing.assert_allclose(got.float().cpu().numpy(), want.numpy(),
                               atol=2e-2, rtol=2e-2)
    qd, kd, vd = (t.to("cuda", torch.bfloat16) for t in rounded)
    close = _rounded_p_attention(qd, kd, vd, causal=False).float()
    err = (got.float() - close).abs()
    limit = TC_ULPS * _bf16_ulp(close) + TC_ATOL
    assert bool((err <= limit).all()), (
        f"max |err| {float(err.max())}, "
        f"max err/limit {float((err / limit).max())}")
