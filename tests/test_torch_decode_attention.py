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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("heads,window", [((9, 1), 0), ((18, 2), 64)])
def test_port_ref_matches_jax_at_nine_heads_a_kv_head(heads, window, dtype):
    """StarCoder2's 9 query heads a kv head (36/4) at a narrow H of 32:
    the kernel takes 8 heads a block, so its second head group holds one
    head; the plain version against the JAX oracle and interpret-mode
    kernel (atol/rtol 2e-5 in fp32, 1e-2 in bf16, as above)."""
    args = _inputs(2, 128, *heads, 32, 0.75, seed=12)
    ours = _port(args, dtype, window=window).float().numpy()
    tol = 2e-5 if dtype == "float32" else 1e-2
    for want in _jax(args, dtype, window=window):
        np.testing.assert_allclose(ours, want, atol=tol, rtol=tol)


def test_nine_heads_a_kv_head_plan_two_head_groups():
    """StarCoder2's decode (B=8, 36/4, an 8192-slot cache): two head
    groups a (row, kv head), 64 clusters, 4 splits each (a divisor of the
    128 tiles near the 2-blocks-an-SM target of 5)."""
    nsplit, per, stages = cuda_mod.plan(8, 4, 9, 8192, num_sms=132)
    assert 8 * 4 * -(-9 // cuda_mod.HEADS) == 64
    assert (nsplit, per, stages) == (4, 32, 2)


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
    """The split plan: the splits of one (row, kv head, head group) form
    one cluster (at most PORTABLE_CLUSTER, or MAX_CLUSTER where the groups
    are too few for the card); split i takes the 64-slot tiles i,
    i + splits, ..., so every tile lies in exactly one split and every
    split has one; about BLOCKS_PER_SM blocks per SM where the cluster
    limit and the cache allow; a ring no deeper than a warp's quarters."""
    for g in (1, 4, 5, 9):
        nsplit, per, stages = cuda_mod.plan(b, nkv, g, sc, num_sms=132)
        tiles = -(-sc // cuda_mod.TILE)
        assert 1 <= nsplit <= min(cuda_mod.MAX_CLUSTER, tiles)
        owned = sorted(t for i in range(nsplit)
                       for t in range(i, tiles, nsplit))
        assert owned == list(range(tiles))
        assert per == -(-tiles // nsplit)
        groups = b * nkv * -(-g // cuda_mod.HEADS)
        target = cuda_mod.BLOCKS_PER_SM * 132
        cap = (cuda_mod.MAX_CLUSTER
               if groups * cuda_mod.PORTABLE_CLUSTER < 132
               else cuda_mod.PORTABLE_CLUSTER)
        assert nsplit <= cap
        assert groups * nsplit >= min(target, groups * min(tiles, cap)) // 2
        want = max(1, min(cap, tiles, -(-target // groups)))
        assert tiles % nsplit == 0 or nsplit == want
        assert 1 <= stages <= min(4, per)


LOG2E = 1.4426950408889634


def _kernel_order_attention(q, k, v, cpos, pos, window=0, nsplit=4,
                            skip=True):
    """The bf16 tensor-core route's arithmetic, transcribed: scores in fp32
    (log2 domain, scale*log2(e) folded); split i of `nsplit` takes the
    64-slot tiles i, i + nsplit, ...; each of its 4 warps walks its 16-slot
    quarter of those tiles with its own online softmax: P = exp2(s - running
    max) rounded to bf16 before P.V, the row sums over the unrounded P,
    invalid slots' V read as 0 (the copy zero-fills them); the warps merge
    in warp order, then the splits in split order, with log-sum-exp
    weights.  With `skip`, a quarter with no valid slot in a row leaves
    that row's state alone, as the kernel never reads it."""
    b, nq, h = q.shape
    sc, nkv = k.shape[1], k.shape[2]
    g = nq // nkv
    neg = -0.7 * torch.finfo(torch.float32).max
    qg = q.float().reshape(b, nkv, g, h)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k.float()) * (h ** -0.5 * LOG2E)
    rel = pos[:, None] - cpos
    valid = (cpos >= 0) & (rel >= 0)
    if window:
        valid &= rel < window
    s = torch.where(valid[:, None, None, :], s, neg)
    vz = torch.where(valid[:, :, None, None], v.float(), 0.0)
    tiles = -(-sc // 64)
    parts = []
    for i in range(nsplit):
        for w in range(4):
            m = torch.full((b, nkv, g), neg)
            l = torch.zeros(b, nkv, g)
            o = torch.zeros(b, nkv, g, h)
            for t in range(i, tiles, nsplit):
                lo = t * 64 + w * 16
                hi = min(lo + 16, sc)
                if lo >= sc:
                    continue
                sq, ok = s[..., lo:hi], valid[:, lo:hi]
                mn = torch.maximum(m, sq.amax(-1))
                corr = torch.exp2(m - mn)
                p = torch.where(ok[:, None, None, :],
                                torch.exp2(sq - mn[..., None]), 0.0)
                l2 = l * corr + p.sum(-1)
                o2 = o * corr[..., None] + torch.einsum(
                    "bkgs,bskd->bkgd", p.bfloat16().float(), vz[:, lo:hi])
                keep = ok.any(-1)[:, None, None] if skip else torch.ones(
                    b, 1, 1, dtype=torch.bool)
                m = torch.where(keep, mn, m)
                l = torch.where(keep, l2, l)
                o = torch.where(keep[..., None], o2, o)
            parts.append((m, l, o))

    def merge(ps):
        mm = torch.stack([p[0] for p in ps]).amax(0)
        ll, oo = torch.zeros_like(mm), torch.zeros_like(ps[0][2])
        for pm, pl, po in ps:                       # in order
            wgt = torch.exp2(pm - mm)
            ll = ll + pl * wgt
            oo = oo + po * wgt[..., None]
        return mm, ll, oo

    blocks = [merge(parts[4 * i:4 * i + 4]) for i in range(nsplit)]
    _, l, o = merge(blocks)                 # warps, then splits, in order
    out = o / l.clamp_min(1e-30)[..., None]
    return out.reshape(b, nq, h).to(q.dtype)


def _bf16_args(args):
    q, k, v, cpos, pos = args
    return ([torch.from_numpy(x).bfloat16() for x in (q, k, v)]
            + [torch.from_numpy(cpos), torch.from_numpy(pos)])


@pytest.mark.parametrize("heads", [(32, 8), (25, 5)])
@pytest.mark.parametrize("window", [0, 96])
def test_bf16_p_rounding_stays_inside_the_bf16_tolerance(heads, window):
    """The tensor-core route's order and P's bf16 rounding keep the result
    within the card test's 1e-2 of the fp32 plain result cast to bf16,
    at Llama's and Hymba's head layouts (H=64), with and without a
    window."""
    args = _bf16_args(_inputs(2, 320, *heads, 64, 0.8, seed=20))
    got = _kernel_order_attention(*args, window=window).float()
    q, k, v, cpos, pos = args
    want = decode_attention_ref(q.float(), k.float(), v.float(), cpos, pos,
                                window=window).bfloat16().float()
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-2,
                               rtol=1e-2)
    assert not torch.equal(got, want)     # the rounding does show


@pytest.mark.parametrize("window", [0, 200])
def test_skipping_empty_tiles_changes_no_bit(window):
    """Skipping the quarters with no valid slot gives the same bits as
    walking them, on caches with empty tiles at the front, in the middle
    and at the end (and, with a window, rows whose old slots fall out)."""
    q, k, v, cpos, pos = _inputs(3, 512, 8, 2, 64, 1.0, seed=21)
    cpos[:, :128] = -1            # front
    cpos[:, 256:384] = -1         # middle
    cpos[1:, 440:] = -1           # end (rows 1 and 2), mid-quarter too
    k[:, cpos[0] < 0] = np.nan    # empty slots may hold anything
    args = _bf16_args((q, k, v, cpos, pos))
    for nsplit in (1, 3, 8):
        skipped = _kernel_order_attention(*args, window=window,
                                          nsplit=nsplit)
        walked = _kernel_order_attention(*args, window=window,
                                         nsplit=nsplit, skip=False)
        assert torch.equal(skipped, walked)
        assert bool(torch.isfinite(skipped.float()).all())
    q2, k2, v2, c2, p2 = args
    want = decode_attention_ref(q2.float(), k2.float().nan_to_num(),
                                v2.float(), c2, p2, window=window)
    np.testing.assert_allclose(skipped.float().numpy(),
                               want.bfloat16().float().numpy(), atol=1e-2,
                               rtol=1e-2)


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


def _routes():
    return cuda_mod.LAUNCHES, cuda_mod.TC_LAUNCHES, cuda_mod.CORE_LAUNCHES


def _check_on_card(args, dtype, window):
    before = _routes()
    got = _port(args, dtype, window=window, device="cuda", impl="auto")
    again = _port(args, dtype, window=window, device="cuda", impl="auto")
    torch.cuda.synchronize()
    # one launch per call, on the dtype's route: bf16 on the tensor cores,
    # fp32 on the CUDA cores
    tc = dtype == "bfloat16"
    assert _routes() == (before[0] + 2, before[1] + 2 * tc,
                         before[2] + 2 * (not tc))
    assert torch.equal(got, again)        # bit for bit, run to run
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
@pytest.mark.parametrize("kind", ["window", "global"])
def test_cuda_kernel_hymba_decode_shapes_on_the_card(kind):
    """Hymba-1.5B's decode: 25/5 heads of 64 at B=8, a 1024-slot rolling
    cache under the 1024 window, or a 4096-slot cache half full."""
    _card()
    if kind == "window":
        _check_on_card(_rolling(8, 1024, 25, 5, 64, first=2048, seed=9),
                       "bfloat16", 1024)
    else:
        _check_on_card(_inputs(8, 4096, 25, 5, 64, 0.5, seed=9),
                       "bfloat16", 0)


def _smem_bytes(dtype, h, stages):
    """decode_attention.cu's Layout<T, HD>::bytes(stages), transcribed:
    per warp a ring of (K, V) quarters of 16 rows of HD + 16 bytes, the
    warps' quarter lists, the block's partial, the cluster's shares, and
    for fp32 q and the warps' weights."""
    hd = next(w for w in (32, 64, 128, 256) if h <= w)
    es = 2 if dtype == "bfloat16" else 4
    stage = 2 * 16 * (hd + 16 // es) * es
    size = 4 * stage * stages + 4 * 128 * 8                  # rings, lists
    size += (2 * 8 + 8 * hd) * 4                             # partial
    size += (2 * 8 * cuda_mod.MAX_CLUSTER + 8 * hd
             + cuda_mod.MAX_CLUSTER) * 4                      # cluster recv
    if es == 4:
        size += 8 * hd * 4 + 4 * (8 * 16 + 8) * 4           # q, weights
    return size


@pytest.mark.parametrize("b,sc,nq,nkv", [(8, 4096, 48, 8), (8, 1024, 16, 8),
                                         (1, 4096, 48, 8)])
def test_head_width_128_plans_a_ring_that_fits_shared_memory(b, sc, nq,
                                                              nkv):
    """Mixtral's decode (48/8 heads of 128 over a 4096-slot rolling cache)
    and InternVL2's (16/8 over 1024 slots) in bf16: the plan's ring depth
    fits a block's shared memory with no stage dropped, and
    BLOCKS_PER_SM blocks of it fit an SM (228 KB on an H100)."""
    nsplit, per, stages = cuda_mod.plan(b, nkv, nq // nkv, sc, num_sms=132)
    assert stages == min(per, cuda_mod.STAGES) == 2
    smem = _smem_bytes("bfloat16", 128, stages)
    assert smem == 83072
    assert smem <= cuda_mod.MAX_SMEM_BYTES
    assert cuda_mod.BLOCKS_PER_SM * smem <= 228 * 1024
    assert _smem_bytes("float32", 128, stages) <= cuda_mod.MAX_SMEM_BYTES


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["mixtral", "internvl2"])
def test_cuda_kernel_head_width_128_shapes_on_the_card(kind):
    """Mixtral-8x22B's decode (48/8 heads of 128, a 4096-slot rolling cache
    under the 4096 window, rows past the window) and InternVL2-2B's (16/8
    heads of 128, 1024 slots full)."""
    _card()
    if kind == "mixtral":
        _check_on_card(_rolling(8, 4096, 48, 8, 128, first=4608, seed=10),
                       "bfloat16", 4096)
    else:
        _check_on_card(_inputs(8, 1024, 16, 8, 128, 1.0, seed=10),
                       "bfloat16", 0)


# StarCoder2-7B's 9 query heads a kv head: the second head group of each
# (row, kv head) holds one head (blockIdx.y = 1, 7 empty mma columns)
NINE = [((8, 8192, 36, 4, 128), "bfloat16", 0.25, 0),    # its serving
        ((3, 1000, 36, 4, 128), "float32", 0.6, 0),
        ((2, 777, 9, 1, 128), "bfloat16", 1.0, 300),
        ((2, 777, 9, 1, 128), "float32", 1.0, 0)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype,fill,window", NINE,
                         ids=["36/4-bf16", "36/4-fp32", "9/1-bf16",
                              "9/1-fp32"])
def test_cuda_kernel_nine_heads_a_kv_head_on_the_card(shape, dtype, fill,
                                                      window):
    _card()
    _check_on_card(_inputs(*shape, fill, seed=13), dtype, window)


@pytest.mark.gpu
def test_cuda_kernel_ignores_nan_in_empty_slots_on_the_card():
    _card()
    q, k, v, cpos, pos = _inputs(2, 512, 8, 2, 64, 0.3, seed=8)
    clean = _port((q, k, v, cpos, pos), device="cuda", impl="cuda")
    k[:, 200:], v[:, 200:] = np.nan, np.nan          # slots 153.. are empty
    dirty = _port((q, k, v, cpos, pos), device="cuda", impl="cuda")
    torch.cuda.synchronize()
    assert torch.equal(clean, dirty)


@pytest.mark.gpu
def test_cuda_kernel_whisper_decode_shape_on_the_card():
    """Whisper-base's decoder self-attention: 8 query heads over 8 kv heads
    (G=1) of 64 in bf16 on the tensor-core route, 448 slots full (its text
    context), at B=4."""
    _card()
    _check_on_card(_inputs(4, 448, 8, 8, 64, 1.0, seed=11), "bfloat16", 0)
