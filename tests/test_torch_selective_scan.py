"""repro_torch.kernels.selective_scan against the JAX package's kernel.

The same numpy inputs go through the port's plain version (ref.py), the
JAX oracle and the JAX Pallas kernel in interpret mode (as
tests/test_kernels.py runs it on the CPU), over the grid of
test_kernels.py (S, Di, N, the Pallas kernel's chunk), plus a start state
h0, ragged S, the model's mixed types (bf16 x/B/C, fp32 dt/A/D) and the
state-carry invariant through the port's ``models.ssm.selective_scan``.
Tolerances: atol/rtol 1e-4 in fp32, as test_kernels.py; 2e-2 where x, B
and C are bf16.  A plain transcription of the CUDA kernel's chunked scan
(local scans from zero, running-product decays, carry pass, rescan) is
held to both plain versions at 1e-5 in fp32.  The CUDA kernel itself runs
only on a card: the `gpu` tests import nothing of JAX, so they also run
where JAX is absent (``pytest --noconftest -m gpu``).
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.selective_scan import \
    selective_scan as cuda_mod  # noqa: E402
from repro_torch.kernels.selective_scan.ops import \
    selective_scan_op  # noqa: E402
from repro_torch.kernels.selective_scan.ref import \
    selective_scan_ref  # noqa: E402
from repro_torch.models.ssm import selective_scan as port_scan  # noqa: E402

GRID = list(itertools.product([64, 128, 192], [32, 64], [4, 16], [32, 64]))
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(b, s, di, n, seed=0, h0=False):
    """x, dt (softplus of a normal), a (negative), b, c, d_skip[, h0] as
    test_kernels.py draws them, from a numpy seed."""
    rng = np.random.default_rng(seed)
    out = [0.5 * rng.standard_normal((b, s, di)),
           np.log1p(np.exp(rng.standard_normal((b, s, di)))),
           -np.exp(0.3 * rng.standard_normal((di, n))),
           0.5 * rng.standard_normal((b, s, n)),
           0.5 * rng.standard_normal((b, s, n)),
           np.ones((di,)) + 0.1 * rng.standard_normal((di,))]
    if h0:
        out.append(rng.standard_normal((b, di, n)))
    return [a.astype(np.float32) for a in out]


def _torch_args(args, dtype="float32", device="cpu"):
    """x, b, c in `dtype`; dt, a, d (and h0) in fp32."""
    dt = _TORCH[dtype]
    return [torch.from_numpy(a).to(device, dt if i in (0, 3, 4)
                                   else torch.float32)
            for i, a in enumerate(args)]


def _port(args, dtype="float32", device="cpu", impl="ref"):
    y, h = selective_scan_op(*_torch_args(args, dtype, device), impl=impl)
    return y, h


def _jax(args, dtype="float32", kernel=None):
    """The JAX oracle and, with a `kernel` chunk, the Pallas kernel in
    interpret mode on the same data."""
    import jax.numpy as jnp
    from repro.kernels.selective_scan.ref import \
        selective_scan_ref as jax_ref
    from repro.kernels.selective_scan.selective_scan import selective_scan
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    x, dt, a, b, c, d = (jnp.asarray(v, jdt if i in (0, 3, 4)
                                     else jnp.float32)
                         for i, v in enumerate(args[:6]))
    h0 = jnp.asarray(args[6]) if len(args) > 6 else None
    outs = [jax_ref(x, dt, a, b, c, d, h0=h0)]
    if kernel:
        outs.append(selective_scan(x, dt, a, b, c, d, block_d=32,
                                   chunk=kernel, interpret=True))
    return [(np.asarray(y, np.float32), np.asarray(h)) for y, h in outs]


def _close(ours, want, tol):
    y, h = ours
    np.testing.assert_allclose(y.float().numpy(), want[0], atol=tol, rtol=tol)
    np.testing.assert_allclose(h.numpy(), want[1], atol=tol, rtol=tol)


@pytest.mark.parametrize("s,di,n,chunk", GRID)
def test_port_ref_matches_jax_ref_and_kernel(s, di, n, chunk):
    args = _inputs(2, s, di, n)
    ours = _port(args)
    for want in _jax(args, kernel=chunk):
        _close(ours, want, 1e-4)


@pytest.mark.parametrize("s,di,n", [(64, 32, 4), (128, 64, 16)])
def test_start_state_h0(s, di, n):
    args = _inputs(2, s, di, n, seed=1, h0=True)
    (want,) = _jax(args)
    _close(_port(args), want, 1e-4)


@pytest.mark.parametrize("s,di,n", [(1000, 96, 4), (77, 40, 16)])
def test_ragged_sequence_with_h0(s, di, n):
    args = _inputs(2, s, di, n, seed=2, h0=True)
    (want,) = _jax(args)
    _close(_port(args), want, 1e-4)


@pytest.mark.parametrize("s,di,n", [(64, 32, 16), (96, 64, 4)])
def test_mixed_types_bf16_x_b_c(s, di, n):
    """The model's types: x, B, C bf16; dt, A, D fp32; y comes back bf16."""
    args = _inputs(1, s, di, n, seed=3)
    y, h = _port(args, "bfloat16")
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    (want,) = _jax(args, "bfloat16")
    _close((y, h), want, 2e-2)


def test_state_carry_equivalence_through_the_model_scan():
    """Scanning [first half] then [second half with h0] == full scan (the
    prefill->decode handoff invariant), through models.ssm.selective_scan,
    and equal to the JAX package's model scan."""
    import jax.numpy as jnp
    from repro.models.ssm import selective_scan as jax_scan
    x, dt, a, b, c, d = _torch_args(_inputs(1, 128, 32, 8, seed=7))
    y_full, h_full = port_scan(x, dt, a, b, c, d)
    y1, h1 = port_scan(x[:, :64], dt[:, :64], a, b[:, :64], c[:, :64], d)
    y2, h2 = port_scan(x[:, 64:], dt[:, 64:], a, b[:, 64:], c[:, 64:], d,
                       h0=h1)
    np.testing.assert_allclose(h2.numpy(), h_full.numpy(), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(),
                               y_full.numpy(), rtol=1e-4, atol=1e-5)
    jy, jh = jax_scan(*(jnp.asarray(t.numpy()) for t in (x, dt, a, b, c, d)),
                      chunk=32)
    np.testing.assert_allclose(y_full.numpy(), np.asarray(jy), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(h_full.numpy(), np.asarray(jh), rtol=1e-4,
                               atol=1e-4)


def test_model_scan_takes_float32_only():
    x, dt, a, b, c, d = _torch_args(_inputs(1, 8, 8, 4))
    with pytest.raises(ValueError, match="scan_dtype"):
        port_scan(x, dt, a, b, c, d, scan_dtype="bfloat16")


def test_auto_on_cpu_runs_the_plain_version_and_launches_nothing():
    args = _inputs(2, 48, 32, 16, seed=4, h0=True)
    before = cuda_mod.LAUNCHES
    got = _port(args, impl="auto")
    assert cuda_mod.LAUNCHES == before
    for g, w in zip(got, _port(args, impl="ref")):
        assert torch.equal(g, w)


def _chunked_scan(x, dt, a, b_ssm, c_ssm, d_skip, h0, chunk):
    """selective_scan.cu's chunked scan in plain PyTorch: (1) each chunk
    but the last scanned from h = 0, keeping its end state and its decay as
    the running product of the same exps; (2) the carry pass from h0 over
    the chunks in order; (3) each chunk scanned again from its true start
    state, giving y; the last chunk's end state is h_end."""
    bsz, s, di = x.shape
    n = a.shape[1]
    xf, dtf, af, bf, cf = (t.float() for t in (x, dt, a, b_ssm, c_ssm))
    zeros = torch.zeros((bsz, di, n))

    def steps(h, lo, hi, ys=None, dec=None):
        for t in range(lo, hi):
            e = torch.exp(dtf[:, t, :, None] * af[None])
            h = e * h + (dtf[:, t] * xf[:, t])[..., None] * bf[:, t, None, :]
            if dec is not None:
                dec = dec * e
            if ys is not None:
                ys.append(torch.einsum("bdn,bn->bd", h, cf[:, t]))
        return h, dec

    bounds = [(lo, min(s, lo + chunk)) for lo in range(0, s, chunk)]
    local = [steps(zeros, lo, hi, dec=torch.ones_like(zeros))
             for lo, hi in bounds[:-1]]
    starts = [zeros if h0 is None else h0.float()]
    for end, dec in local:
        starts.append(dec * starts[-1] + end)
    ys = []
    for (lo, hi), h in zip(bounds, starts):
        h, _ = steps(h, lo, hi, ys=ys)
    y = torch.stack(ys, dim=1) + xf * d_skip.float()
    return y.to(x.dtype), h


@pytest.mark.parametrize("chunk", [1, 7, 64, None])
@pytest.mark.parametrize("h0", [False, True])
def test_chunked_scan_matches_both_plain_versions(chunk, h0):
    """Chunk lengths 1, 7, 64 (ragged last chunks of 100 steps) and S."""
    args = _inputs(2, 100, 24, 16, seed=9, h0=h0)
    targs = _torch_args(args)
    ours = _chunked_scan(*targs[:6], targs[6] if h0 else None,
                         chunk=chunk or 100)
    y, h = _port(args)
    _close(ours, (y.float().numpy(), h.numpy()), 1e-5)
    (want,) = _jax(args)
    _close(ours, want, 1e-5)


@pytest.mark.parametrize("shape,chunks", [((1, 2048, 3200, 16), 11),
                                          ((8, 512, 3200, 16), 1),
                                          ((1, 4096, 3200, 16), 11),
                                          ((2, 1000, 200, 32), 32),
                                          ((1, 10, 64, 16), 1)])
def test_chunk_rule(shape, chunks):
    """One pass where B*Di threads fill the card (Hymba's wave); else
    chunks of a multiple of 16 steps (Hymba's refill: 11 of 192)."""
    bsz, s, di, n = shape
    length = cuda_mod.chunk_len(bsz, s, di, n)
    assert -(-s // length) == chunks
    assert length == s or length % cuda_mod.STEP == 0


@pytest.mark.parametrize("impl", ["cuda", "bogus"])
def test_cuda_or_unknown_impl_on_a_cpu_tensor_raises(impl):
    args = _inputs(1, 8, 8, 4, seed=5)
    before = cuda_mod.LAUNCHES
    with pytest.raises(ValueError):
        _port(args, impl=impl)
    assert cuda_mod.LAUNCHES == before


# -- on the card -----------------------------------------------------------
CARD = [((1, 2048, 3200, 16), "bfloat16", False),
        ((8, 512, 3200, 16), "bfloat16", False),
        ((1, 4096, 3200, 16), "bfloat16", False),     # 11 chunks of 384
        ((1, 10, 64, 16), "float32", True),           # S below one chunk
        ((1, 1000, 200, 16), "float32", True),        # ragged last chunk
        ((2, 300, 200, 8), "bfloat16", True),         # Di % 128 != 0
        ((2, 1000, 96, 4), "float32", True),
        ((3, 130, 70, 8), "float32", False),
        ((2, 64, 33, 32), "float32", True),
        ((1, 65, 17, 3), "bfloat16", True)]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype,h0", CARD)
def test_cuda_kernel_matches_plain_version_on_the_card(shape, dtype, h0):
    _card()
    args = _inputs(*shape, seed=8, h0=h0)
    before = cuda_mod.LAUNCHES
    y, h = _port(args, dtype, device="cuda", impl="auto")
    torch.cuda.synchronize()
    assert cuda_mod.LAUNCHES == before + 1
    want_y, want_h = selective_scan_op(*_torch_args(args, dtype, "cuda"),
                                       impl="ref")
    tol = 1e-4 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(y.float().cpu().numpy(),
                               want_y.float().cpu().numpy(), atol=tol,
                               rtol=tol)
    np.testing.assert_allclose(h.cpu().numpy(), want_h.cpu().numpy(),
                               atol=1e-4, rtol=1e-4)
