"""repro_torch.kernels.kmeans against the JAX package's kmeans kernel.

The same numpy inputs go through the JAX Pallas kernel (interpret mode,
as tests/test_kernels.py runs it on the CPU), the JAX oracle and the
port's plain version, over the grid of test_kernels.py plus the paper's
scenario-iii width (K=5000 with a ragged N).  Tolerances as
test_kernels.py: 1e-4 in float32 and 5e-2 in bfloat16 for the sums and
the SSE, counts exact.  The CUDA kernel itself runs only on a card: the
`gpu` tests import nothing of JAX, so they also run where JAX is absent
(``pytest --noconftest -m gpu``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.kmeans import kmeans as cuda_kmeans  # noqa: E402
from repro_torch.kernels.kmeans.ops import kmeans_assign_op  # noqa: E402
from repro_torch.kernels.kmeans.ref import kmeans_assign_ref  # noqa: E402

GRID = [(n, d, k, dtype)
        for n in (256, 512, 1000) for d in (4, 8, 32) for k in (5, 16, 64)
        for dtype in ("float32", "bfloat16")] + [(1037, 8, 5000, "float32")]

_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(n, d, k, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((n, d)).astype(np.float32)
    cen = rng.standard_normal((k, d)).astype(np.float32)
    return pts, cen


def _assert_close(got, want, dtype):
    tol = 1e-4 if dtype == "float32" else 5e-2
    s1, c1, e1 = (np.asarray(v, dtype=np.float32) for v in got)
    s2, c2, e2 = (np.asarray(v, dtype=np.float32) for v in want)
    np.testing.assert_allclose(s1, s2, rtol=tol, atol=tol * 10)
    np.testing.assert_array_equal(c1, c2)
    np.testing.assert_allclose(float(e1), float(e2), rtol=tol)


@pytest.mark.parametrize("n,d,k,dtype", GRID)
def test_port_ref_matches_jax_kernel_and_oracle(n, d, k, dtype):
    import jax.numpy as jnp
    from repro.kernels.kmeans.ops import kmeans_assign_op as jax_assign_op
    from repro.kernels.kmeans.ref import kmeans_assign_ref as jax_assign_ref

    pts, cen = _inputs(n, d, k)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    jp, jc = jnp.asarray(pts, jdt), jnp.asarray(cen, jdt)
    tp = torch.from_numpy(pts).to(_TORCH[dtype])
    tc = torch.from_numpy(cen).to(_TORCH[dtype])
    ours = kmeans_assign_op(tp, tc, impl="ref")
    _assert_close(ours, jax_assign_op(jp, jc, block_n=128,
                                      impl="interpret"), dtype)
    _assert_close(ours, jax_assign_ref(jp, jc), dtype)
    assert float(ours[1].sum()) == n


def test_auto_on_cpu_runs_the_plain_version_and_launches_nothing():
    pts, cen = _inputs(300, 8, 7, seed=1)
    before = cuda_kmeans.LAUNCHES
    got = kmeans_assign_op(torch.from_numpy(pts), torch.from_numpy(cen))
    want = kmeans_assign_ref(torch.from_numpy(pts), torch.from_numpy(cen))
    assert cuda_kmeans.LAUNCHES == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("impl", ["cuda", "bogus"])
def test_cuda_or_unknown_impl_on_a_cpu_tensor_raises(impl):
    pts, cen = _inputs(64, 8, 4, seed=2)
    before = cuda_kmeans.LAUNCHES
    with pytest.raises(ValueError):
        kmeans_assign_op(torch.from_numpy(pts), torch.from_numpy(cen),
                         impl=impl)
    assert cuda_kmeans.LAUNCHES == before


@pytest.mark.gpu
@pytest.mark.parametrize("n,k,d,dtype", [(1037, 64, 32, "float32"),
                                         (4096, 50, 8, "float32"),
                                         (4096, 50, 8, "bfloat16")])
def test_cuda_kernel_matches_plain_version_on_the_card(n, k, d, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    pts, cen = _inputs(n, d, k, seed=3)
    tp = torch.from_numpy(pts).to("cuda", _TORCH[dtype])
    tc = torch.from_numpy(cen).to("cuda", _TORCH[dtype])
    before = cuda_kmeans.LAUNCHES
    got = kmeans_assign_op(tp, tc)
    torch.cuda.synchronize()
    assert cuda_kmeans.LAUNCHES == before + 1
    want = kmeans_assign_ref(tp, tc)
    _assert_close([t.cpu() for t in got], [t.cpu() for t in want], dtype)
