"""repro_torch.kernels.decode_attention against the JAX package's kernel.

The same numpy inputs go through the port's plain version (ref.py), the
JAX oracle and the JAX Pallas kernel in interpret mode (as
tests/test_kernels.py runs it on the CPU), over the grid of
test_kernels.py (Sc, heads, H, window, fill).  Tolerances: atol/rtol 2e-5
in fp32 as test_kernels.py; 1e-2 in bf16.  The CUDA kernel itself runs
only on a card: the `gpu` tests import nothing of JAX, so they also run
where JAX is absent (``pytest --noconftest -m gpu``).
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.decode_attention import \
    decode_attention as cuda_mod  # noqa: E402
from repro_torch.kernels.decode_attention.ops import \
    decode_attention_op  # noqa: E402
from repro_torch.kernels.decode_attention.ref import \
    decode_attention_ref  # noqa: E402

GRID = list(itertools.product([128, 256], [(4, 2), (8, 2), (6, 3)], [32, 64],
                              [0, 64], [0.25, 1.0]))
BF16_GRID = [g for g in GRID if g[0] == 128 and g[4] == 1.0]
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(b, sc, nq, nkv, h, fill_frac, seed=0):
    """Slots 0..fill-1 hold positions 0..fill-1, the rest are empty (-1);
    the current position is the last filled slot."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, nq, h)).astype(np.float32)
    k = rng.standard_normal((b, sc, nkv, h)).astype(np.float32)
    v = rng.standard_normal((b, sc, nkv, h)).astype(np.float32)
    fill = max(1, int(sc * fill_frac))
    cpos = np.where(np.arange(sc) < fill, np.arange(sc), -1)
    cpos = np.broadcast_to(cpos, (b, sc)).astype(np.int32).copy()
    pos = np.full((b,), fill - 1, np.int32)
    return q, k, v, cpos, pos


def _rolling(b, sc, nq, nkv, h, first, seed=0):
    """A rolling cache: row i is at position first+i and holds the last
    `sc` positions, position p in slot p % sc."""
    q, k, v, _, _ = _inputs(b, sc, nq, nkv, h, 1.0, seed)
    pos = (first + np.arange(b)).astype(np.int32)
    cpos = np.empty((b, sc), np.int32)
    for i, cur in enumerate(pos):
        held = np.arange(cur - sc + 1, cur + 1)
        cpos[i, held % sc] = held
    return q, k, v, cpos, pos


def _port(args, dtype="float32", window=0, device="cpu", impl="ref"):
    q, k, v, cpos, pos = args
    dt = _TORCH[dtype]
    t = [torch.from_numpy(x).to(device, dt) for x in (q, k, v)]
    t += [torch.from_numpy(cpos).to(device), torch.from_numpy(pos).to(device)]
    return decode_attention_op(*t, window=window, impl=impl)


def _jax(args, dtype="float32", window=0):
    """(JAX oracle, JAX Pallas kernel in interpret mode) on the same data."""
    import jax.numpy as jnp
    from repro.kernels.decode_attention.decode_attention import \
        decode_attention
    from repro.kernels.decode_attention.ref import \
        decode_attention_ref as jax_ref
    q, k, v, cpos, pos = args
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    jq, jk, jv = (jnp.asarray(x, jdt) for x in (q, k, v))
    jc, jp = jnp.asarray(cpos), jnp.asarray(pos)
    ref = jax_ref(jq, jk, jv, jc, jp, window=window)
    ker = decode_attention(jq, jk, jv, jc, jp, window=window, block_k=64,
                           interpret=True)
    return (np.asarray(ref, np.float32), np.asarray(ker, np.float32))


@pytest.mark.parametrize("sc,heads,h,window,fill_frac", GRID)
def test_port_ref_matches_jax_ref_and_kernel_fp32(sc, heads, h, window,
                                                   fill_frac):
    args = _inputs(2, sc, *heads, h, fill_frac)
    ours = _port(args, window=window).numpy()
    for want in _jax(args, window=window):
        np.testing.assert_allclose(ours, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("sc,heads,h,window,fill_frac", BF16_GRID)
def test_port_ref_matches_jax_ref_and_kernel_bf16(sc, heads, h, window,
                                                   fill_frac):
    args = _inputs(2, sc, *heads, h, fill_frac, seed=1)
    ours = _port(args, "bfloat16", window=window)
    assert ours.dtype == torch.bfloat16
    for want in _jax(args, "bfloat16", window=window):
        np.testing.assert_allclose(ours.float().numpy(), want, atol=1e-2,
                                   rtol=1e-2)


def test_empty_slots_are_ignored():
    """Garbage in empty (-1) slots must not affect the output."""
    q, k, v, cpos, pos = _inputs(1, 128, 4, 2, 32, 40 / 128, seed=2)
    o1 = _port((q, k, v, cpos, pos)).numpy()
    k2, v2 = k.copy(), v.copy()
    k2[:, 40:] += 100.0
    v2[:, 40:] += 100.0
    o2 = _port((q, k2, v2, cpos, pos)).numpy()
    np.testing.assert_allclose(o1, o2, atol=1e-6)
    for want in _jax((q, k2, v2, cpos, pos)):
        np.testing.assert_allclose(o2, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("window", [64, 48])
def test_rolling_window_cache(window):
    """Sc=64 holding the last 64 positions at slot p % Sc, positions past
    Sc (the cache has wrapped), window = Sc and window < Sc."""
    args = _rolling(3, 64, 8, 2, 32, first=200, seed=3)
    ours = _port(args, window=window).numpy()
    for want in _jax(args, window=window):
        np.testing.assert_allclose(ours, want, atol=2e-5, rtol=2e-5)


def test_auto_on_cpu_runs_the_plain_version_and_launches_nothing():
    args = _inputs(2, 128, 8, 2, 32, 0.5, seed=4)
    before = cuda_mod.LAUNCHES
    got = _port(args, impl="auto")
    assert cuda_mod.LAUNCHES == before
    assert torch.equal(got, _port(args, impl="ref"))


@pytest.mark.parametrize("impl", ["cuda", "bogus"])
def test_cuda_or_unknown_impl_on_a_cpu_tensor_raises(impl):
    args = _inputs(1, 64, 4, 2, 16, 1.0, seed=5)
    before = cuda_mod.LAUNCHES
    with pytest.raises(ValueError):
        _port(args, impl=impl)
    assert cuda_mod.LAUNCHES == before


@pytest.mark.parametrize("b,nkv,sc", [(8, 8, 1024), (1, 8, 32768),
                                      (3, 3, 1000), (2, 8, 512), (1, 1, 1),
                                      (64, 8, 4096)])
def test_split_plan_covers_the_cache(b, nkv, sc):
    """The split plan: whole tiles per split, every slot in exactly one
    split, about BLOCKS_PER_SM blocks per SM where the cache is long
    enough."""
    chunk, nsplit = cuda_mod.plan(b, nkv, sc, num_sms=132)
    assert chunk % cuda_mod.TILE == 0
    assert (nsplit - 1) * chunk < sc <= nsplit * chunk
    tiles = -(-sc // cuda_mod.TILE)
    target = cuda_mod.BLOCKS_PER_SM * 132
    assert b * nkv * nsplit >= min(target, b * nkv * tiles) // 2


# -- on the card -----------------------------------------------------------
CARD = [((8, 1024, 32, 8, 64), "bfloat16", 0.25, 0),
        ((8, 1024, 32, 8, 64), "bfloat16", 1.0, 0),
        ((3, 1000, 6, 3, 32), "float32", 1.0, 0),
        ((2, 512, 8, 8, 64), "float32", 0.5, 0),
        ((2, 300, 4, 1, 256), "float32", 0.7, 96),
        ((2, 300, 4, 1, 20), "float32", 0.7, 0)]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


def _check_on_card(args, dtype, window):
    before = cuda_mod.LAUNCHES
    got = _port(args, dtype, window=window, device="cuda", impl="auto")
    torch.cuda.synchronize()
    assert cuda_mod.LAUNCHES == before + 1
    # the plain version in fp32 on the same (dtype-rounded) inputs
    q, k, v, cpos, pos = args
    rounded = [torch.from_numpy(x).to(_TORCH[dtype]).float()
               for x in (q, k, v)]
    want = decode_attention_ref(*rounded, torch.from_numpy(cpos),
                                torch.from_numpy(pos), window=window)
    tol = 2e-5 if dtype == "float32" else 1e-2
    want = want.to(_TORCH[dtype]).float()
    np.testing.assert_allclose(got.float().cpu().numpy(), want.numpy(),
                               atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype,fill,window", CARD)
def test_cuda_kernel_matches_plain_version_on_the_card(shape, dtype, fill,
                                                       window):
    _card()
    _check_on_card(_inputs(*shape, fill, seed=6), dtype, window)


@pytest.mark.gpu
def test_cuda_kernel_rolling_window_on_the_card():
    _card()
    _check_on_card(_rolling(8, 256, 32, 8, 64, first=1000, seed=7),
                   "bfloat16", 256)


@pytest.mark.gpu
def test_cuda_kernel_ignores_nan_in_empty_slots_on_the_card():
    _card()
    q, k, v, cpos, pos = _inputs(2, 512, 8, 2, 64, 0.3, seed=8)
    clean = _port((q, k, v, cpos, pos), device="cuda", impl="cuda")
    k[:, 200:], v[:, 200:] = np.nan, np.nan          # slots 153.. are empty
    dirty = _port((q, k, v, cpos, pos), device="cuda", impl="cuda")
    torch.cuda.synchronize()
    assert torch.equal(clean, dirty)
