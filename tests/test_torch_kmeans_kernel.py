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


# one partition (N/8) of each of the paper's three scenarios
PARTITIONS = [(125_000, 50), (12_500, 500), (1_250, 5_000)]


def _partition_inputs(n, k):
    from repro_torch.core.analytics import make_blobs
    pts, _ = make_blobs(n, min(k, 256), d=8, seed=11)
    cen = np.random.default_rng(12).normal(size=(k, 8)).astype(np.float32)
    return pts, cen


def _butterfly(lanes):
    """warp_sum in kmeans.cu: s += shfl_xor(s, off) for off 16..1."""
    lanes = list(lanes)
    off = 16
    while off:
        lanes = [lanes[ln] + lanes[ln ^ off] for ln in range(32)]
        off //= 2
    return lanes[0]


def _in_order(vals):
    """A float32 sum taken left to right, from 0."""
    tot = torch.zeros(vals.shape[1:])
    for v in vals:
        tot = tot + v
    return tot


def _smem_floats(mode, sub, kchunk, rstep, k, d):
    """kmeans.cu::smem_floats."""
    w = cuda_kmeans.WARPS
    p1 = kchunk * (d + 1) + cuda_kmeans.FIXED_FLOATS
    if mode == 0:
        return p1 + (w if sub == 1 else 1) * (k * (d + 1) + 1)
    return max(p1, w * rstep * (d + 1))


def _fused_order_assign(points, centroids, num_sms=132):
    """The fused kernel's order, transcribed (kmeans.py::plan, kmeans.cu).
    Each point's argmin over the K-chunks in increasing chunk order (strict
    '<', so the first index wins).  Mode 0: block b walks tiles b, b+grid,
    ...; warp w of a block adds its points in point order, the warps'
    partials add in warp order; each output sums the blocks' partials in R
    contiguous ranges of blocks (R = min(grid, 256 // m, 16) for a slice of
    m outputs), the ranges in order.  Mode 1: the points of centroid c add in
    point order within each warp (warp = (p // 32) % 8) and the warps in
    order.  The SSE: per-thread running sums, a butterfly per warp, warps
    in order, blocks in order."""
    x, c = points.float(), centroids.float()
    n, d = x.shape
    k = c.shape[0]
    mode, sub, rows, nkc, kchunk, rstep, grid = cuda_kmeans.plan(n, k, d,
                                                                 num_sms)
    c2 = (c * c).sum(1)
    x2 = (x * x).sum(1)
    best = torch.full((n,), float("inf"))
    idx = torch.full((n,), -1)
    for i in range(nkc):                                  # chunk order
        lo, hi = i * kchunk, min(k, (i + 1) * kchunk)
        d2 = x2[:, None] - 2.0 * (x @ c[lo:hi].T) + c2[lo:hi]
        bv, bi = d2.min(1)
        take = (bv < best) | (idx < 0)
        best = torch.where(take, bv, best)
        idx = torch.where(take, bi + lo, idx)
    xa = torch.cat([x, torch.ones(n, 1)], 1)             # coordinates, 1
    tile = cuda_kmeans.TILE
    if mode == 0:
        tp = tile // sub                    # a tile: `rows` rows of tp
        p = torch.arange(n)
        blk = (p // (rows * tp)) % grid
        warp = (p % tp) // 32
        part = torch.zeros(grid, k * (d + 1) + 1)
        for b in range(grid):
            ws = []
            for w in range(tile // 32 if sub == 1 else 1):
                sel = (blk == b) & (warp == w)
                ws.append(torch.nn.functional.one_hot(idx[sel], k).float().T
                          @ xa[sel])
            part[b, :-1] = _in_order(torch.stack(ws)).reshape(-1)
            # the SSE: thread (w, lane) over its tiles, then the trees
            wl = torch.zeros(tile // sub)
            for t in range(b, -(-n // (rows * tp)), grid):   # tile order
                for u in range(rows):                        # then row
                    lo = (t * rows + u) * tp
                    pts = best[lo:lo + tp]
                    wl[:len(pts)] += pts
            part[b, -1] = _in_order(torch.stack(
                [_butterfly(wl[w * 32:(w + 1) * 32])
                 for w in range(len(wl) // 32)]))
        vlen = k * (d + 1) + 1
        big_e = -(-vlen // grid)
        out = torch.zeros(vlen)
        for b in range(grid):
            e0 = b * big_e
            ne = max(0, min(big_e, vlen - e0))
            for eb in range(0, ne, tile):
                m = min(tile, ne - eb)
                r = min(grid, tile // m, 16)
                rg = -(-grid // r)
                cols = part[:, e0 + eb:e0 + eb + m]
                out[e0 + eb:e0 + eb + m] = _in_order(torch.stack(
                    [_in_order(cols[q * rg:(q + 1) * rg])
                     if q * rg < grid else torch.zeros(m)
                     for q in range(r)]))
        sums = out[:-1].reshape(k, d + 1)
        return sums[:, :d], sums[:, d], out[-1]
    warp = (torch.arange(n) // 32) % cuda_kmeans.WARPS
    sums = _in_order(torch.stack(
        [torch.nn.functional.one_hot(idx[warp == w], k).float().T
         @ xa[warp == w] for w in range(cuda_kmeans.WARPS)]))
    span = grid * tile                      # thread (b, t): p = b*256 + t
    padded = torch.zeros(-(-n // span) * span)
    padded[:n] = best
    threads = _in_order(padded.reshape(-1, grid, tile))   # (grid, 256)
    blocks = [_in_order(torch.stack([_butterfly(threads[b, w * 32:
                                                        (w + 1) * 32])
                                     for w in range(cuda_kmeans.WARPS)]))
              for b in range(grid)]
    lanes = [sum(blocks[ln::32], torch.zeros(())) for ln in range(32)]
    return sums[:, :d], sums[:, d], _butterfly(lanes)


@pytest.mark.parametrize("n,k", PARTITIONS)
def test_fused_reduction_order_matches_plain_and_jax(n, k):
    """The fused kernel's fixed order (block partials in block order, the
    K-chunk argmin merged in chunk order, the points of a centroid in warp
    order) against the port's plain version and the JAX oracle at the
    three partition shapes: 1e-5, counts exact."""
    from repro.kernels.kmeans.ref import kmeans_assign_ref as jax_assign_ref
    pts, cen = _partition_inputs(n, k)
    got = _fused_order_assign(torch.from_numpy(pts), torch.from_numpy(cen))
    for want in (kmeans_assign_ref(torch.from_numpy(pts),
                                   torch.from_numpy(cen)),
                 jax_assign_ref(pts, cen)):
        s1, c1, e1 = (np.asarray(t, dtype=np.float32) for t in got)
        s2, c2, e2 = (np.asarray(t, dtype=np.float32) for t in want)
        np.testing.assert_array_equal(c1, c2)
        np.testing.assert_allclose(s1, s2, rtol=1e-5, atol=1e-5 * np.abs(
            s2).max())
        np.testing.assert_allclose(float(e1), float(e2), rtol=1e-5)
    assert float(got[1].sum()) == n


@pytest.mark.parametrize("n,k", PARTITIONS + [(1_000_000, 50), (0, 5),
                                             (300, 7), (1037, 5000)])
def test_fused_plan_fits_one_cluster_and_the_card(n, k):
    """The plan of one launch fits a block's shared memory, asks for no
    more than BLOCKS_PER_SM blocks per SM (all resident) nor more blocks
    than work items, puts every centroid in one chunk and splits K only in
    mode 1, where each block keeps one chunk; the paper's partitions take
    the paths the kernel's note names."""
    d = 8
    mode, sub, rows, nkc, kchunk, rstep, grid = cuda_kmeans.plan(
        n, k, d, num_sms=132)
    assert 1 <= grid <= cuda_kmeans.BLOCKS_PER_SM * 132
    assert (nkc - 1) * kchunk < k <= nkc * kchunk
    assert sub in (1, cuda_kmeans.WARPS)
    assert rows in (1, 2) and (rows == 1 or (sub == 1 and mode == 0))
    tiles = -(-n // (rows * cuda_kmeans.TILE // sub))
    assert grid <= max(1, tiles * nkc)
    if -(-n // cuda_kmeans.TILE) >= 132:
        assert sub == 1
    assert (_smem_floats(mode, sub, kchunk, rstep, k, d)
            <= cuda_kmeans.SMEM_FLOATS)
    if mode == 0:
        assert nkc == 1 and kchunk == k
    else:
        assert mode == 1 and rstep >= 1 and grid % nkc == 0
    expect = {(125_000, 50): (0, 1), (12_500, 500): (0, 8),
              (1_250, 5_000): (1, 8)}
    if (n, k) in expect:
        assert (mode, sub) == expect[(n, k)]
    if (n, k) == (1_250, 5_000):      # every SM has an item
        assert nkc > 1 and grid >= 100


@pytest.mark.parametrize("n,k,d", [(256, 2000, 1024), (100, 8000, 1024),
                                   (40_000, 64, 20)])
def test_fused_plan_wide_rows_fit_in_chunks_and_passes(n, k, d):
    """Rows too wide for one chunk: K in chunks that fit shared memory (more
    chunks than blocks where they must be, each block then reloading its
    chunk per item), and the final scan in passes of rstep centroids."""
    mode, sub, rows, nkc, kchunk, rstep, grid = cuda_kmeans.plan(
        n, k, d, num_sms=132)
    assert (_smem_floats(mode, sub, kchunk, rstep, k, d)
            <= cuda_kmeans.SMEM_FLOATS)
    assert (nkc - 1) * kchunk < k <= nkc * kchunk
    if (n, k) == (40_000, 64):
        assert (mode, sub) == (0, 1)
        return
    assert mode == 1 and rstep < -(-k // grid)       # more than one pass
    if k == 8000:
        assert nkc > grid


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


def _blob_inputs(n, d, k, seed):
    """Points near random centroids (noise 0.1), so that no near-tie in a
    long dot product can move a point between clusters."""
    rng = np.random.default_rng(seed)
    cen = rng.standard_normal((k, d)).astype(np.float32)
    pts = (cen[rng.integers(0, k, size=n)]
           + 0.1 * rng.standard_normal((n, d))).astype(np.float32)
    return pts, cen


# each path of kmeans.cu: mode 0 with sub 8 and with per-warp partials
# (any D, D in registers, two rows per thread), mode 1 in one pass, in
# several passes, and with more K-chunks than blocks
@pytest.mark.gpu
@pytest.mark.parametrize("n,k,d,dtype", [(1037, 64, 32, "float32"),
                                         (4096, 50, 8, "float32"),
                                         (4096, 50, 8, "bfloat16"),
                                         (1250, 5000, 8, "float32"),
                                         (300, 7, 20, "float32"),
                                         (40_000, 64, 20, "float32"),
                                         (125_000, 50, 8, "bfloat16"),
                                         (125_000, 16, 4, "float32"),
                                         (10_000, 5000, 8, "bfloat16"),
                                         (256, 2000, 1024, "float32"),
                                         (100, 8000, 1024, "float32")])
def test_cuda_kernel_matches_plain_version_on_the_card(n, k, d, dtype):
    _card()
    make = _blob_inputs if d > 32 else _inputs
    pts, cen = make(n, d, k, seed=3)
    tp = torch.from_numpy(pts).to("cuda", _TORCH[dtype])
    tc = torch.from_numpy(cen).to("cuda", _TORCH[dtype])
    before = cuda_kmeans.LAUNCHES
    got = kmeans_assign_op(tp, tc)
    again = kmeans_assign_op(tp, tc)
    torch.cuda.synchronize()
    assert cuda_kmeans.LAUNCHES == before + 2
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    want = kmeans_assign_ref(tp, tc)
    _assert_close([t.cpu() for t in got], [t.cpu() for t in want], dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("n,k", PARTITIONS)
def test_cuda_kernel_partitions_repeat_bit_for_bit_on_the_card(n, k):
    """The three partition shapes: the plain version's counts, sums and
    SSE, and two calls on the same inputs give the same bits."""
    _card()
    pts, cen = _partition_inputs(n, k)
    tp, tc = torch.from_numpy(pts).cuda(), torch.from_numpy(cen).cuda()
    first = kmeans_assign_op(tp, tc)
    second = kmeans_assign_op(tp, tc)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    _assert_close([t.cpu() for t in first],
                  [t.cpu() for t in kmeans_assign_ref(tp, tc)], "float32")


@pytest.mark.gpu
@pytest.mark.parametrize("tier", ["device", "host"])
def test_kmeans_over_float64_points_on_the_card(tier):
    """float64 points reach the kernel as fp32 from either tier (the device
    tier stores them narrowed, assign_partial casts host-tier points), one
    launch per partition and iteration, with the CPU run's SSE history."""
    _card()
    from repro_torch.core import DataUnit, kmeans, make_backend
    pts = np.random.default_rng(0).normal(size=(1000, 8))
    hist = []
    for dev in ("cuda", "cpu"):
        backends = {"host": make_backend("host"),
                    "device": make_backend("device", device=dev)}
        du = DataUnit.from_array("p64", pts, 4, backends, tier=tier)
        before = cuda_kmeans.LAUNCHES
        hist.append(kmeans(du, k=5, iters=4, seed=0).sse_history)
        launched = cuda_kmeans.LAUNCHES - before
        assert launched == (16 if dev == "cuda" else 0), (dev, launched)
    np.testing.assert_allclose(hist[0], hist[1], rtol=1e-4)
