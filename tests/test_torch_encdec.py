"""repro_torch's enc-dec family (Whisper) against the JAX package, on the CPU.

Function level, fp32 at atol 1e-5 on weights drawn from a numpy seed with
a 1/sqrt(fan-in) scale: ``encoder_attention`` (bidirectional, RoPE),
``cross_attention`` with Sq = the prompt and Sq = 1 against T encoder
frames, ``cross_kv``, ``encoder_forward`` and ``encdec_decoder_forward``
(hidden state and both caches).  Attention goes through
``flash_attention_op``, non-causal for the encoder and for cross
attention; on a CPU tensor that is the kernel's plain version.  Model
level, on ``reduced(whisper_base)`` (2 encoder and 2 decoder layers,
4/2 heads of 16, 16 frames) with the JAX init carried across and frames
``0.1 * normal`` from a seed, as tests/test_models.py feeds them: fp32
prefill logits at atol 1e-4 and the same greedy tokens; bf16 by the
model-level rule; the init tree (``enc_layers``, ``enc_norm``, ``xattn``)
and the cache spec (``cross`` a (k, v) tuple); the decode kernel route
against the inline plain decode; the frames moving the logits.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs.base import reduced as ref_reduced  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro.models import transformer as ref_tfm  # noqa: E402
from repro.models.model import build_model as ref_build_model  # noqa: E402
from repro_torch.carry import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import reduced  # noqa: E402
from repro_torch.kernels.flash_attention import \
    flash_attention as flash_mod  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serving import splice_row  # noqa: E402

ARCH = "whisper_base"
B, PROMPT, STEPS, MAX_LEN = 2, 10, 6, 32


def _cfgs(dtype="float32", **over):
    over = {"dtype": dtype, "decode_kernel": False, **over}
    return (ref_reduced(ref_get_config(ARCH), **over),
            reduced(get_config(ARCH), **over))


def _draw(specs, seed):
    """numpy leaves for a (JAX) ParamSpec tree: norms at 1, the rest
    normal with std 1/sqrt(the product of the input axes, the layer axis
    of a stacked leaf left out)."""
    rng = np.random.default_rng(seed)

    def leaf(s):
        if s.init == "ones":
            return np.ones(s.shape, np.float32)
        lead = 1 if s.logical[0] == "layers" else 0
        fan_in = int(np.prod(s.shape[lead:-1]))
        return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(
            np.float32)
    return jax.tree.map(leaf, specs, is_leaf=lambda s: hasattr(s, "init"))


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _positions(s):
    return np.broadcast_to(np.arange(s, dtype=np.int32), (B, s)).copy()


def test_encoder_attention_matches_the_reference():
    rcfg, pcfg = _cfgs()
    p = _draw(ref_attn.gqa_specs(rcfg), 1)
    t = rcfg.encoder_seq_len
    x, pos = _normal(2, B, t, rcfg.d_model), _positions(t)
    want = ref_attn.encoder_attention(jax.tree.map(jnp.asarray, p),
                                      jnp.asarray(x), cfg=rcfg,
                                      positions=jnp.asarray(pos))
    got = attn.encoder_attention(params_from_numpy(p, "cpu"),
                                 torch.from_numpy(x), cfg=pcfg,
                                 positions=torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("sq", [PROMPT, 1])
def test_cross_attention_and_cross_kv_match_the_reference(sq):
    """The decoder's queries (the prompt, or one decode token) against the
    encoder's T frames, through cross_kv's projections."""
    rcfg, pcfg = _cfgs()
    p = _draw(ref_attn.gqa_specs(rcfg), 3)
    enc = _normal(4, B, rcfg.encoder_seq_len, rcfg.d_model)
    x = _normal(5, B, sq, rcfg.d_model)
    jp, tp = jax.tree.map(jnp.asarray, p), params_from_numpy(p, "cpu")
    wk, wv = ref_attn.cross_kv(jp, jnp.asarray(enc))
    gk, gv = attn.cross_kv(tp, torch.from_numpy(enc))
    np.testing.assert_allclose(gk.numpy(), np.asarray(wk), atol=1e-5, rtol=0)
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), atol=1e-5, rtol=0)
    want = ref_attn.cross_attention(jp, jnp.asarray(x), wk, wv, cfg=rcfg)
    got = attn.cross_attention(tp, torch.from_numpy(x), gk, gv, cfg=pcfg)
    assert tuple(got.shape) == (B, sq, rcfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def _model_draw(seed):
    rcfg, pcfg = _cfgs()
    p = _draw(ref_tfm.model_specs(rcfg), seed)
    return rcfg, pcfg, jax.tree.map(jnp.asarray, p), params_from_numpy(
        p, "cpu")


def test_encoder_forward_matches_the_reference():
    rcfg, pcfg, jp, tp = _model_draw(6)
    frames = 0.1 * _normal(7, B, rcfg.encoder_seq_len, rcfg.d_model)
    want = ref_tfm.encoder_forward(jp, jnp.asarray(frames), rcfg)
    got = tfm.encoder_forward(tp, torch.from_numpy(frames), pcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_encdec_decoder_forward_matches_the_reference():
    """The hidden state, the self-attention K/V (post-RoPE) and the cross
    K/V, each stacked over the layers."""
    rcfg, pcfg, jp, tp = _model_draw(8)
    enc = _normal(9, B, rcfg.encoder_seq_len, rcfg.d_model)
    x, pos = _normal(10, B, PROMPT, rcfg.d_model), _positions(PROMPT)
    wx, (wkv, wcross) = ref_tfm.encdec_decoder_forward(
        jp, jnp.asarray(x), jnp.asarray(enc), rcfg,
        positions=jnp.asarray(pos), need_cache=True)
    gx, (gkv, gcross) = tfm.encdec_decoder_forward(
        tp, torch.from_numpy(x), torch.from_numpy(enc), pcfg,
        positions=torch.from_numpy(pos), need_cache=True)
    np.testing.assert_allclose(gx.numpy(), np.asarray(wx), atol=1e-5, rtol=0)
    for g, w in zip(gkv + gcross, tuple(wkv) + tuple(wcross)):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0)
    nx, none = tfm.encdec_decoder_forward(
        tp, torch.from_numpy(x), torch.from_numpy(enc), pcfg,
        positions=torch.from_numpy(pos))
    assert none is None and torch.equal(nx, gx)


# -- the model -------------------------------------------------------------
def _pair(dtype, decode_kernel=False):
    rcfg, pcfg = _cfgs(dtype, decode_kernel=decode_kernel)
    ref, port = ref_build_model(rcfg), build_model(pcfg)
    jp = ref.init(jax.random.key(0))
    if dtype == "float32":
        jp = jax.tree.map(lambda t: t.astype(jnp.float32), jp)
    return ref, port, jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                            "cpu")


def _batch(cfg, seed, jax_side):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, PROMPT)).astype(
               np.int32),
           "frames": (0.1 * rng.standard_normal(
               (B, cfg.encoder_seq_len, cfg.d_model))).astype(np.float32)}
    conv = jnp.asarray if jax_side else torch.from_numpy
    return {k: conv(v) for k, v in out.items()}


def _gen(m, params, batch, feed, *, jax_side):
    """Prefill + STEPS decode steps teaching `feed` (None: greedy) ->
    (logits per step, tokens fed, the prefill cache)."""
    conv = jnp.asarray if jax_side else torch.from_numpy
    logits, cache = m.prefill(params, batch, max_len=MAX_LEN)
    first = cache
    to_np = lambda t: np.asarray(t if jax_side else t.float(), np.float32)
    outs, fed = [to_np(logits)], []
    for t in range(STEPS):
        cur = (np.asarray(logits.argmax(-1), np.int32) if feed is None
               else feed[t])
        fed.append(cur)
        pos = np.full((B,), PROMPT + t, np.int32)
        logits, out = m.decode(params, cache, conv(cur.copy())[:, None],
                               conv(pos))
        if not jax_side:
            assert out is cache                  # decode updates in place
        cache = out
        outs.append(to_np(logits))
    return outs, fed, first


def _drawn_pair():
    """The fp32 models with one param tree drawn by `_draw` on the JAX
    spec tree (the embedding table at unit scale), carried across."""
    ref, port, _, _ = _pair("float32")
    p = _draw(ref_tfm.model_specs(ref.cfg), 18)
    p["embed"] = _normal(19, *p["embed"].shape)
    return ref, port, jax.tree.map(jnp.asarray, p), params_from_numpy(
        p, "cpu")


@pytest.mark.parametrize("seed", [11, 12])
def test_fp32_prefill_and_greedy_decode_match_the_reference(seed):
    """Prefill and decode logits at atol 1e-4 and the same greedy tokens,
    on params drawn at a 1/sqrt(fan-in) scale (`_draw`)."""
    ref, port, jp, tp = _drawn_pair()
    want, want_toks, _ = _gen(ref, jp, _batch(port.cfg, seed, True), None,
                              jax_side=True)
    got, got_toks, _ = _gen(port, tp, _batch(port.cfg, seed, False), None,
                            jax_side=False)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(np.stack(got_toks), np.stack(want_toks))


@pytest.mark.parametrize("seed", [11, 12])
def test_fp32_greedy_tokens_match_on_the_reference_init(seed):
    """The JAX package's own init, carried across: the same greedy tokens.
    Its stacked leaves take the layer count as fan-in (std 0.7 at two
    layers), which makes the cross-attention softmax so sharp that fp32
    summation-order differences inside the layers can exceed 1e-4 on the
    logits; the logits are held on drawn params instead (above)."""
    ref, port, jp, tp = _pair("float32")
    _, want_toks, _ = _gen(ref, jp, _batch(port.cfg, seed, True), None,
                           jax_side=True)
    _, got_toks, _ = _gen(port, tp, _batch(port.cfg, seed, False), None,
                          jax_side=False)
    np.testing.assert_array_equal(np.stack(got_toks), np.stack(want_toks))


def test_bf16_prefill_and_decode_within_bf16_rounding():
    """bf16, the JAX side's greedy tokens taught to both: the port lies no
    further from the JAX bf16 logits than those lie from the JAX fp32 run
    on the same (cast) params, frames and tokens."""
    ref, port, jp, tp = _pair("bfloat16")
    ref32 = ref_build_model(_cfgs("float32")[0])
    jp32 = jax.tree.map(lambda t: t.astype(jnp.float32), jp)
    want, feed, _ = _gen(ref, jp, _batch(port.cfg, 13, True), None,
                         jax_side=True)
    want32, _, _ = _gen(ref32, jp32, _batch(port.cfg, 13, True), feed,
                        jax_side=True)
    got, _, _ = _gen(port, tp, _batch(port.cfg, 13, False), feed,
                     jax_side=False)
    gap = max(float(np.abs(g - w).max()) for g, w in zip(got, want))
    bf16_err = max(float(np.abs(w - v).max()) for w, v in zip(want, want32))
    assert all(np.isfinite(g).all() for g in got)
    assert gap <= bf16_err, (gap, bf16_err)


def test_decode_kernel_route_matches_the_plain_route_fp32():
    """decode_kernel=True (decode_attention_op; on the CPU its plain
    version) against the inline plain decode attention, in the port, fp32
    on drawn params; the same tokens taught to both."""
    _, plain, _, tp = _drawn_pair()
    kern = build_model(_cfgs("float32", decode_kernel=True)[1])
    want, feed, _ = _gen(plain, tp, _batch(plain.cfg, 14, False), None,
                         jax_side=False)
    got, _, _ = _gen(kern, tp, _batch(plain.cfg, 14, False), feed,
                     jax_side=False)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5)


def test_decode_kernel_route_within_bf16_rounding_of_the_plain_route():
    """bf16 on the JAX init: the kernel route (fp32 probabilities and
    P.V, one cast) lies no further from the inline plain route (bf16
    probabilities before P.V) than the plain route lies from the fp32
    model on the same params and tokens -- the model-level rule of the
    chip checks."""
    _, plain, jp, tp = _pair("bfloat16")
    kern = build_model(_cfgs("bfloat16", decode_kernel=True)[1])
    m32 = build_model(_cfgs("float32")[1])
    p32 = params_from_numpy(jax.tree.map(
        lambda t: np.asarray(t.astype(jnp.float32)), jp), "cpu")
    want, feed, _ = _gen(plain, tp, _batch(plain.cfg, 14, False), None,
                         jax_side=False)
    got, _, _ = _gen(kern, tp, _batch(plain.cfg, 14, False), feed,
                     jax_side=False)
    want32, _, _ = _gen(m32, p32, _batch(plain.cfg, 14, False), feed,
                        jax_side=False)
    gap = max(float(np.abs(g - w).max()) for g, w in zip(got, want))
    bf16_err = max(float(np.abs(w - v).max()) for w, v in zip(want, want32))
    assert gap <= bf16_err, (gap, bf16_err)


def test_frames_move_the_logits_and_prefill_runs_flash_per_layer():
    """The encoder and cross attention are on the path: other frames give
    other logits, and zero frames give cross K/V of zero (every encoder
    layer maps 0 to 0).  On the CPU flash_attention_op runs its plain
    version: no launch."""
    _, port, _, tp = _pair("float32")
    before = (flash_mod.LAUNCHES, flash_mod.TC_LAUNCHES)
    batch = _batch(port.cfg, 15, False)
    a, _ = port.prefill(tp, batch, max_len=MAX_LEN)
    batch["frames"] = torch.zeros_like(batch["frames"])
    b, cache = port.prefill(tp, batch, max_len=MAX_LEN)
    assert float((a - b).abs().max()) > 1e-3
    assert all(float(t.abs().max()) == 0.0 for t in cache["main"]["cross"])
    assert (flash_mod.LAUNCHES, flash_mod.TC_LAUNCHES) == before


def test_init_matches_the_reference_tree():
    ref, port = (ref_build_model(_cfgs("bfloat16")[0]),
                 build_model(_cfgs("bfloat16")[1]))
    jp = jax.tree.map(np.asarray, ref.init(jax.random.key(0)))
    tp = port.init(torch.Generator().manual_seed(0), device="cpu")
    paths = lambda t: [jax.tree_util.keystr(k) for k, _ in
                       jax.tree_util.tree_flatten_with_path(t)[0]]
    assert paths(tp) == paths(jp)
    for w, g in zip(jax.tree.leaves(jp), jax.tree.leaves(tp)):
        assert tuple(g.shape) == w.shape
        assert str(g.dtype).split(".")[-1] == w.dtype.name
    assert set(tp) == {"embed", "final_norm", "lm_head", "enc_layers",
                       "enc_norm", "layers"}
    assert {"norm_x", "xattn"} <= set(tp["layers"])


def test_cache_spec_matches_the_prefill_cache_and_the_reference():
    """{"main": {"kv": {"k","v","pos"}, "cross": (k, v)}}: the self-attention
    cache of max_len slots and the encoder's K/V (L,B,T,nkv,hd)."""
    ref, port, _, tp = _pair("float32")
    _, cache = port.prefill(tp, _batch(port.cfg, 16, False), max_len=MAX_LEN)
    is_spec = lambda t: (isinstance(t, tuple) and len(t) == 2
                         and isinstance(t[0], tuple)
                         and all(isinstance(n, int) for n in t[0]))
    want = jax.tree.leaves(ref.cache_spec(B, MAX_LEN), is_leaf=is_spec)
    got = jax.tree.leaves(port.cache_spec(B, MAX_LEN), is_leaf=is_spec)
    assert [(tuple(s), tuple(l)) for s, l in got] == \
        [(tuple(s), tuple(l)) for s, l in want]
    assert [tuple(t.shape) for t in tree_leaves(cache)] == \
        [tuple(s) for s, _ in got]
    assert isinstance(cache["main"]["cross"], tuple)
    assert cache["main"]["kv"]["pos"].dtype == torch.int32


@pytest.mark.parametrize("b", [1, 3])
def test_splice_row_writes_the_cross_cache_row(b):
    """A refill's batch-of-1 cache (a shorter prompt, other frames)
    spliced into row 1 of a batch of 3, or over the whole leaves at a
    batch of 1: every leaf, the cross (k, v) tuple's (L,1,T,nkv,hd)
    included, lands at its batch axis (1) in every layer, and no other row
    changes."""
    _, port, _, tp = _pair("float32")
    batch = _batch(port.cfg, 17, False)
    wave = {k: v[:1].expand((b,) + tuple(v.shape[1:])).contiguous()
            for k, v in batch.items()}
    _, cache = port.prefill(tp, wave, max_len=MAX_LEN)
    before = [t.clone() for t in tree_leaves(cache)]
    row = {"tokens": batch["tokens"][1:2, :PROMPT - 3],
           "frames": batch["frames"][1:2]}
    _, row_cache = port.prefill(tp, row, max_len=MAX_LEN)
    r = min(1, b - 1)
    with torch.inference_mode():         # as the engine's serving loop
        assert splice_row(cache, row_cache, r) is cache
    ek, ev = cache["main"]["cross"]
    assert tuple(ek.shape)[:2] == (port.cfg.num_layers, b)
    for new, old, src in zip(tree_leaves(cache), before,
                             tree_leaves(row_cache)):
        assert new.shape[1] == b and src.shape[1] == 1
        assert torch.equal(new.narrow(1, r, 1), src)
        for i in set(range(b)) - {r}:
            assert torch.equal(new.narrow(1, i, 1), old.narrow(1, i, 1))
    assert not torch.equal(ek, before[0])      # the cross k did change
