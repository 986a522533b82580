"""repro_torch's MLA family (DeepSeek-V3) against the JAX package, on the CPU.

Function level: ``mla_forward`` (the prefill: latent expanded to per-head
K/V, chunked causal attention with the scale of the full QK width) and
``mla_decode`` (the absorbed matmuls against the latent cache), fp32 at
atol 1e-5, on weights drawn from a numpy seed with a 1/sqrt(fan-in)
scale.  Model level, on ``reduced(deepseek_v3_671b)`` (one dense MLA
layer, then one MoE layer of 4 experts top-2 with a shared expert and the
sigmoid router, MTP module in the tree) with the JAX init carried across
by ``carry.params_from_numpy``: fp32 prefill logits at atol 1e-4 and the
same greedy tokens; bf16 by the model-level rule (the port's logits lie no
further from the JAX package's bf16 logits than those lie from its fp32
run); the init tree and the cache spec; and, in the port alone, the
absorbed decode at position t against a prefill over t+1 tokens (equal in
exact arithmetic; fp32, atol 1e-4).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs.base import reduced as ref_reduced  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro.models.model import build_model as ref_build_model  # noqa: E402
from repro_torch.carry import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import reduced  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

ARCH = "deepseek_v3_671b"
B, PROMPT, STEPS, MAX_LEN = 2, 12, 6, 32


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


def _layer_inputs(seed=0, s=PROMPT):
    rcfg, pcfg = _cfgs()
    params = _draw(ref_attn.mla_specs(rcfg), seed)
    x = np.random.default_rng(seed + 1).standard_normal(
        (B, s, rcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (B, s)).copy()
    return rcfg, pcfg, params, x, pos


@pytest.mark.parametrize("chunk", [attn.MLA_CHUNK, 5])
def test_mla_forward_matches_the_reference(chunk):
    """The port's prefill at its own query chunk (and at 5, which leaves a
    ragged last chunk) against the JAX package's one chunk of 1024."""
    rcfg, pcfg, params, x, pos = _layer_inputs(seed=1)
    want = np.asarray(ref_attn.mla_forward(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x), cfg=rcfg,
        positions=jnp.asarray(pos)))
    got, (c_kv, k_rope) = attn.mla_forward(
        params_from_numpy(params, "cpu"), torch.from_numpy(x), cfg=pcfg,
        positions=torch.from_numpy(pos), chunk=chunk, return_cache=True)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    _, _, wc, wr = ref_attn._mla_qkv_latent(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x), cfg=rcfg,
        positions=jnp.asarray(pos))
    np.testing.assert_allclose(c_kv.numpy(), np.asarray(wc), atol=1e-5)
    np.testing.assert_allclose(k_rope.numpy(), np.asarray(wr), atol=1e-5)


def test_mla_decode_matches_the_reference():
    """One absorbed decode step against a latent cache holding 9 of 16
    slots (the rest empty), rows at different positions: the output, and
    the cache with the new token written at slot pos % max_len."""
    rcfg, pcfg, params, x, _ = _layer_inputs(seed=2, s=1)
    m, sc = rcfg.mla, 16
    rng = np.random.default_rng(3)
    cache = {
        "c_kv": rng.standard_normal((B, sc, m.kv_lora_rank)).astype(
            np.float32),
        "k_rope": rng.standard_normal((B, sc, m.qk_rope_head_dim)).astype(
            np.float32),
        "pos": np.where(np.arange(sc) < 9, np.arange(sc), -1)[None].repeat(
            B, 0).astype(np.int32)}
    positions = np.array([9, 7], np.int32)
    wy, wc = ref_attn.mla_decode(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x),
        jax.tree.map(jnp.asarray, cache), cfg=rcfg,
        positions=jnp.asarray(positions))
    tc = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    gy, out = attn.mla_decode(params_from_numpy(params, "cpu"),
                              torch.from_numpy(x), tc, cfg=pcfg,
                              positions=torch.from_numpy(positions))
    assert out is tc                           # written in place
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), atol=1e-5, rtol=0)
    for name in ("c_kv", "k_rope", "pos"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(wc[name]),
                                   atol=1e-5, rtol=0)
    assert tc["pos"][1].tolist()[7] == 7 and tc["pos"][0].tolist()[9] == 9


def _pair(dtype):
    rcfg, pcfg = _cfgs(dtype)
    ref, port = ref_build_model(rcfg), build_model(pcfg)
    jp = ref.init(jax.random.key(0))
    if dtype == "float32":
        jp = jax.tree.map(lambda t: t.astype(jnp.float32), jp)
    return ref, port, jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                            "cpu")


def _prompt(vocab, seed, s=PROMPT):
    return np.random.default_rng(seed).integers(
        0, vocab, (B, s)).astype(np.int32)


def _gen(m, params, prompt, feed, *, jax_side):
    """Prefill + STEPS decode steps teaching `feed` (None: greedy) ->
    (logits per step, tokens fed, the prefill cache)."""
    conv = jnp.asarray if jax_side else torch.from_numpy
    logits, cache = m.prefill(params, {"tokens": conv(prompt)},
                              max_len=MAX_LEN)
    first = cache
    to_np = lambda t: np.asarray(t if jax_side else t.float(), np.float32)
    outs, fed = [to_np(logits)], []
    for t in range(STEPS):
        cur = (np.asarray(logits.argmax(-1), np.int32) if feed is None
               else feed[t])
        fed.append(cur)
        pos = np.full((B,), prompt.shape[1] + t, np.int32)
        logits, out = m.decode(params, cache, conv(cur.copy())[:, None],
                               conv(pos))
        if not jax_side:
            assert out is cache                  # decode updates in place
        cache = out
        outs.append(to_np(logits))
    return outs, fed, first


def test_fp32_prefill_and_greedy_decode_match_the_reference():
    ref, port, jp, tp = _pair("float32")
    prompt = _prompt(port.cfg.vocab_size, seed=4)
    want, want_toks, _ = _gen(ref, jp, prompt, None, jax_side=True)
    got, got_toks, _ = _gen(port, tp, prompt, None, jax_side=False)
    np.testing.assert_allclose(got[0], want[0], atol=1e-4, rtol=0)
    np.testing.assert_array_equal(np.stack(got_toks), np.stack(want_toks))
    for w, g in zip(want[1:], got[1:]):
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=0)


def test_bf16_prefill_and_decode_within_bf16_rounding():
    """bf16, the JAX side's greedy tokens taught to both: the port lies no
    further from the JAX bf16 logits than those lie from the JAX fp32 run
    on the same (cast) params and tokens."""
    ref, port, jp, tp = _pair("bfloat16")
    ref32 = ref_build_model(_cfgs("float32")[0])
    jp32 = jax.tree.map(lambda t: t.astype(jnp.float32), jp)
    prompt = _prompt(port.cfg.vocab_size, seed=5)
    want, feed, _ = _gen(ref, jp, prompt, None, jax_side=True)
    want32, _, _ = _gen(ref32, jp32, prompt, feed, jax_side=True)
    got, _, _ = _gen(port, tp, prompt, feed, jax_side=False)
    gap = max(float(np.abs(g - w).max()) for g, w in zip(got, want))
    bf16_err = max(float(np.abs(w - v).max()) for w, v in zip(want, want32))
    assert all(np.isfinite(g).all() for g in got)
    assert gap <= bf16_err, (gap, bf16_err)


def test_init_matches_the_reference_tree():
    """Same paths, shapes and dtypes as the JAX init: the MLA projections,
    the dense first stack, the MoE stack (router in fp32) and the MTP
    module that only training reads."""
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
    assert set(tp["mtp"]) == {"norm_h", "norm_e", "proj", "layer",
                              "final_norm"}
    assert set(tp["layers_dense"]["attn"]) == {
        "wq_a", "q_norm", "wq_b", "wkv_a", "kv_norm", "wk_b", "wv_b", "wo"}


def test_cache_spec_matches_the_prefill_cache_and_the_reference():
    """The latent cache {"c_kv","k_rope","pos"} of max_len slots under
    "dense" and "main", each leaf with its layer axis; the prompt's
    positions in slots 0..S-1 and -1 after."""
    ref, port, _, tp = _pair("float32")
    _, cache = port.prefill(tp, {"tokens": torch.from_numpy(
        _prompt(port.cfg.vocab_size, seed=6))}, max_len=MAX_LEN)
    is_spec = lambda t: (isinstance(t, tuple) and len(t) == 2
                         and isinstance(t[0], tuple))
    want = jax.tree.leaves(ref.cache_spec(B, MAX_LEN), is_leaf=is_spec)
    got = jax.tree.leaves(port.cache_spec(B, MAX_LEN), is_leaf=is_spec)
    assert [(tuple(s), tuple(l)) for s, l in got] == \
        [(tuple(s), tuple(l)) for s, l in want]
    assert [tuple(t.shape) for t in tree_leaves(cache)] == \
        [tuple(s) for s, _ in got]
    assert set(cache) == {"dense", "main"}
    kv = cache["main"]["kv"]
    assert set(kv) == {"c_kv", "k_rope", "pos"}
    assert kv["pos"].dtype == torch.int32 and kv["c_kv"].dtype == torch.float32
    assert kv["pos"][0, 1].tolist() == (list(range(PROMPT))
                                        + [-1] * (MAX_LEN - PROMPT))


def test_absorbed_decode_matches_the_expanded_prefill():
    """The logits of decode at position t (absorbed matmuls over the
    latent cache) against those of a prefill over the t+1 tokens
    (per-head K/V expanded from the latent): equal in exact arithmetic,
    fp32 at atol 1e-4.  Capacity factor 8 so that no token overflows an
    expert in either (the groups differ between the two)."""
    rcfg, pcfg = _cfgs("float32")
    pcfg = dataclasses.replace(pcfg, moe=dataclasses.replace(
        pcfg.moe, capacity_factor=8.0))
    port = build_model(pcfg)
    tp = port.init(torch.Generator().manual_seed(7), device="cpu")
    prompt = _prompt(pcfg.vocab_size, seed=7)
    outs, fed, _ = _gen(port, tp, prompt, None, jax_side=False)
    seq = prompt
    for t in range(STEPS):
        seq = np.concatenate([seq, fed[t][:, None]], axis=1)
        want, _ = port.prefill(tp, {"tokens": torch.from_numpy(seq)},
                               max_len=MAX_LEN)
        np.testing.assert_allclose(outs[t + 1], want.numpy(), atol=1e-4,
                                   rtol=0)


def test_dense_only_cut_has_no_moe_cache():
    """DeepSeek-V3 cut to its leading dense layers (the card's model
    check): the MoE stack has no layers, hence no cache; prefill and
    decode run the dense stack alone."""
    _, pcfg = _cfgs("float32", num_layers=1)
    assert pcfg.moe.first_k_dense == 1
    port = build_model(pcfg)
    tp = port.init(torch.Generator().manual_seed(8), device="cpu")
    assert tp["layers"]["attn"]["wq_a"].shape[0] == 0
    outs, _, cache = _gen(port, tp, _prompt(pcfg.vocab_size, seed=8), None,
                          jax_side=False)
    assert set(cache) == {"dense"} and set(port.cache_spec(B, MAX_LEN)) == \
        {"dense"}
    assert all(np.isfinite(o).all() for o in outs)
