"""repro_torch.models against the JAX package's models, on the CPU.

The JAX model's own random params (init RNGs cannot match) are carried
into the port with ``carry.params_from_numpy``; the same numpy prompts go
through both.  Configs: ``reduced(llama3_2_1b)`` and the same with
``sliding_window=8`` (prompts longer than the window, so the rolling
cache is built from prefill and wraps during decode), and the SSM and
hybrid families, ``reduced(falcon_mamba_7b)`` and ``reduced(hymba_1_5b)``
(window 32 and one global layer, prompts of 40 tokens).  The port's
decode runs ``decode_kernel=False`` where it is held to the JAX package's
plain decode.  Tolerances: fp32 (``cfg.dtype="float32"``, leaves cast to
fp32 on both sides) logits at atol 1e-4 with equal greedy tokens; bf16 at
atol/rtol 5e-2 as tests/test_serving.py holds the decode kernel, with the
JAX side's greedy tokens fed to both so that a near-tie cannot fork the
sequences.  In bf16 the port's prefill attention rounds like its kernel
(fp32 probabilities and P.V, one cast at the end) where the JAX plain path
rounds the probabilities and the P.V product in bf16; the 5e-2 bound holds
the Llama cases with that difference (measured below 7e-3).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs.base import reduced as ref_reduced  # noqa: E402
from repro.models.model import build_model as ref_build_model  # noqa: E402
from repro_torch.carry import (params_from_numpy,  # noqa: E402
                               params_to_numpy)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import reduced  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

CASES = {"full": {}, "swa8": {"sliding_window": 8}}
B, PROMPT, STEPS, MAX_LEN = 2, 12, 6, 32


def _models(case, dtype, **extra):
    over = dict(CASES[case], dtype=dtype, decode_kernel=False)
    over.update(extra)
    ref = ref_build_model(ref_reduced(ref_get_config("llama3_2_1b"), **over))
    port = build_model(reduced(get_config("llama3_2_1b"), **over))
    return ref, port


def _ref_params(ref, dtype):
    p = ref.init(jax.random.key(0))
    if dtype == "float32":
        p = jax.tree.map(lambda x: x.astype(jnp.float32), p)
    return p


def _prompt(vocab, seed=1):
    return np.random.default_rng(seed).integers(
        0, vocab, (B, PROMPT)).astype(np.int32)


def _run_ref(m, params, prompt, feed=None):
    """Prefill + STEPS greedy decode steps -> (logits per step, tokens fed)."""
    logits, cache = m.prefill(params, {"tokens": jnp.asarray(prompt)},
                              max_len=MAX_LEN)
    outs, fed = [np.asarray(logits, np.float32)], []
    pos = jnp.full((B,), PROMPT, jnp.int32)
    for t in range(STEPS):
        cur = (np.asarray(jnp.argmax(logits, -1), np.int32) if feed is None
               else feed[t])
        fed.append(cur)
        logits, cache = m.decode(params, cache, jnp.asarray(cur)[:, None],
                                 pos)
        outs.append(np.asarray(logits, np.float32))
        pos = pos + 1
    return outs, fed


def _run_port(m, params, prompt, feed=None):
    logits, cache = m.prefill(params, {"tokens": torch.from_numpy(prompt)},
                              max_len=MAX_LEN)
    outs, fed = [logits.float().numpy()], []
    pos = torch.full((B,), PROMPT, dtype=torch.int32)
    for t in range(STEPS):
        cur = (logits.argmax(-1).to(torch.int32).numpy() if feed is None
               else feed[t])
        fed.append(cur)
        tok = torch.from_numpy(np.array(cur))[:, None]
        logits, out_cache = m.decode(params, cache, tok, pos)
        assert out_cache is cache          # decode updates in place
        outs.append(logits.float().numpy())
        pos = pos + 1
    return outs, fed


@pytest.mark.parametrize("case", sorted(CASES))
def test_fp32_prefill_and_greedy_decode_match_the_reference(case):
    ref, port = _models(case, "float32")
    jp = _ref_params(ref, "float32")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    prompt = _prompt(port.cfg.vocab_size)
    want, want_toks = _run_ref(ref, jp, prompt)
    got, got_toks = _run_port(port, tp, prompt)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(np.stack(got_toks), np.stack(want_toks))


@pytest.mark.parametrize("case", sorted(CASES))
def test_bf16_prefill_and_decode_match_the_reference(case):
    ref, port = _models(case, "bfloat16")
    jp = _ref_params(ref, "bfloat16")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(tp))
    prompt = _prompt(port.cfg.vocab_size, seed=2)
    want, feed = _run_ref(ref, jp, prompt)
    got, _ = _run_port(port, tp, prompt, feed=feed)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, atol=5e-2, rtol=5e-2)


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5),
                                        ("bfloat16", 5e-2)])
@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_kernel_path_matches_the_plain_path(case, dtype, atol):
    """decode_kernel=True (decode_attention_op; on the CPU its plain
    version) against the plain-torch decode attention, in the port."""
    ref, plain = _models(case, dtype)
    _, kern = _models(case, dtype, decode_kernel=True)
    tp = params_from_numpy(
        jax.tree.map(np.asarray, _ref_params(ref, dtype)), "cpu")
    prompt = _prompt(plain.cfg.vocab_size, seed=3)
    want, feed = _run_port(plain, tp, prompt)
    got, _ = _run_port(kern, tp, prompt, feed=feed)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, atol=atol, rtol=atol)


def _round_trip(tree):
    back = params_to_numpy(params_from_numpy(tree, "cpu"))
    want, got = jax.tree.leaves(tree), jax.tree.leaves(back)
    assert jax.tree.structure(tree) == jax.tree.structure(back)
    for w, g in zip(want, got):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hymba_params_round_trip_bit_for_bit(dtype):
    """Hymba's bf16 tree holds the SSM's fp32 leaves (dt_bias, a_log,
    d_skip) beside the bf16 ones: each keeps its dtype and its bits."""
    ref, _ = _family("hymba_1_5b", dtype)
    tree = jax.tree.map(np.asarray, _ref_params(ref, dtype))
    kinds = {k: tree["layers"]["ssm"][k].dtype.name
             for k in ("dt_bias", "a_log", "d_skip", "w_in")}
    assert kinds == {"dt_bias": "float32", "a_log": "float32",
                     "d_skip": "float32", "w_in": dtype}
    _round_trip(tree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_round_trip_bit_for_bit(dtype):
    ref, _ = _models("full", dtype)
    _round_trip(jax.tree.map(np.asarray, _ref_params(ref, dtype)))


def test_init_matches_the_reference_tree():
    """The port's init gives the JAX package's tree: same paths, shapes
    and dtypes (bf16 leaves), drawn from a torch generator."""
    ref, port = _models("full", "bfloat16")
    jp = jax.tree.map(np.asarray, ref.init(jax.random.key(0)))
    tp = port.init(torch.Generator().manual_seed(0), device="cpu")
    paths = lambda t: [jax.tree_util.keystr(k) for k, _ in
                       jax.tree_util.tree_flatten_with_path(t)[0]]
    assert paths(tp) == paths(jp)
    for w, g in zip(jax.tree.leaves(jp), jax.tree.leaves(tp)):
        assert tuple(g.shape) == w.shape and g.dtype == torch.bfloat16
    again = port.init(torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(tp), tree_leaves(again)))


@pytest.mark.parametrize("arch", ["yi_9b", "starcoder2_7b", "deepseek_67b"])
def test_other_dense_configs_match_the_reference_fp32(arch):
    """The rest of the dense GQA family (starcoder2's 2-matrix GELU FFN
    included), reduced, fp32, kernel decode path."""
    over = dict(dtype="float32", decode_kernel=True)
    ref = ref_build_model(ref_reduced(ref_get_config(arch), **over))
    port = build_model(reduced(get_config(arch), **over))
    jp = _ref_params(ref, "float32")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    prompt = _prompt(port.cfg.vocab_size, seed=4)
    want, feed = _run_ref(ref, jp, prompt)
    got, _ = _run_port(port, tp, prompt, feed=feed)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=0)


@pytest.mark.parametrize("arch", ["mixtral_8x22b", "deepseek_v3_671b",
                                  "whisper_base", "internvl2_2b"])
def test_other_families_raise_not_implemented(arch):
    with pytest.raises(NotImplementedError, match="Model families"):
        build_model(reduced(get_config(arch)))


def test_cache_spec_matches_prefill_cache():
    _, port = _models("swa8", "float32")
    tp = port.init(torch.Generator().manual_seed(0), device="cpu")
    _, cache = port.prefill(tp, {"tokens": torch.from_numpy(
        _prompt(port.cfg.vocab_size))}, max_len=MAX_LEN)
    spec = port.cache_spec(B, MAX_LEN)
    for name, (shape, _) in spec["main"]["kv"].items():
        assert tuple(cache["main"]["kv"][name].shape) == shape
    assert cache["main"]["kv"]["pos"].dtype == torch.int32
    # the rolling cache holds the last `window` positions at slot p % Sc
    pos = cache["main"]["kv"]["pos"][0, 0]
    sc = port.cfg.sliding_window
    assert sorted(pos.tolist()) == list(range(PROMPT - sc, PROMPT))
    assert all(int(p) % sc == s for s, p in enumerate(pos))


# -- the SSM and hybrid families ----------------------------------------------
FAMILIES = ["falcon_mamba_7b", "hymba_1_5b"]
F_PROMPT, F_MAX_LEN = 40, 64     # prompts past the reduced window of 32


def _family(arch, dtype, **extra):
    over = dict(dtype=dtype, decode_kernel=False)
    over.update(extra)
    return (ref_build_model(ref_reduced(ref_get_config(arch), **over)),
            build_model(reduced(get_config(arch), **over)))


def _family_run(m, params, prompt, feed, *, jax_side):
    """Prefill + len(feed) decode steps teaching `feed` (None: greedy) ->
    (logits per step, tokens fed, the prefill cache)."""
    tokens = jnp.asarray(prompt) if jax_side else torch.from_numpy(prompt)
    logits, cache = m.prefill(params, {"tokens": tokens}, max_len=F_MAX_LEN)
    first = cache
    b = prompt.shape[0]
    outs, fed = [np.asarray(logits.float() if not jax_side else logits,
                            np.float32)], []
    for t in range(STEPS):
        cur = (np.asarray(logits.argmax(-1), np.int32) if feed is None
               else feed[t])
        fed.append(cur)
        pos = np.full((b,), F_PROMPT + t, np.int32)
        if jax_side:
            logits, cache = m.decode(params, cache, jnp.asarray(cur)[:, None],
                                     jnp.asarray(pos))
        else:
            logits, out = m.decode(params, cache,
                                   torch.from_numpy(cur.copy())[:, None],
                                   torch.from_numpy(pos))
            assert out is cache              # decode updates in place
        outs.append(np.asarray(logits.float() if not jax_side else logits,
                               np.float32))
    return outs, fed, first


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_fp32_prefill_and_greedy_decode_match_the_reference(arch):
    ref, port = _family(arch, "float32")
    jp = _ref_params(ref, "float32")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    prompt = np.random.default_rng(11).integers(
        0, port.cfg.vocab_size, (B, F_PROMPT)).astype(np.int32)
    want, want_toks, _ = _family_run(ref, jp, prompt, None, jax_side=True)
    got, got_toks, _ = _family_run(port, tp, prompt, None, jax_side=False)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(np.stack(got_toks), np.stack(want_toks))


def test_hymba_bf16_prefill_and_decode_match_the_reference():
    """bf16, the JAX side's greedy tokens fed to both.  Tolerance 0.1 x
    max|logits|, for three roundings that differ by design: prefill
    attention in fp32 probabilities (the kernel's rounding, see the module
    doc); y = h.C + D*x summed in fp32 before one cast (the JAX model scan
    casts h.C to bf16, then adds D*x in bf16); and the scan's fp32
    summation order (sequential here, a chunked associative scan in the
    JAX package) on a random-weight state that grows to ~3e5, where one
    bf16 step of y is 2048.  Measured 1.3% of max|logits|.  Falcon-mamba
    is held in fp32 only: its SSM output enters the residual unnormalised
    (hymba's passes through ssm_norm), and the same rounding differences
    grew to 0.88 on logits of about 3 within six decode steps on one seed
    (5.8% on another)."""
    ref, port = _family("hymba_1_5b", "bfloat16")
    jp = _ref_params(ref, "bfloat16")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    prompt = np.random.default_rng(12).integers(
        0, port.cfg.vocab_size, (B, F_PROMPT)).astype(np.int32)
    want, feed, _ = _family_run(ref, jp, prompt, None, jax_side=True)
    got, _, _ = _family_run(port, tp, prompt, feed, jax_side=False)
    scale = max(float(np.abs(w).max()) for w in want)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, atol=0.1 * scale, rtol=0)


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_decode_kernel_path_matches_the_plain_path(arch):
    """decode_kernel=True (decode_attention_op; on the CPU its plain
    version) against the inline plain decode attention, fp32."""
    _, plain = _family(arch, "float32")
    _, kern = _family(arch, "float32", decode_kernel=True)
    tp = plain.init(torch.Generator().manual_seed(3), device="cpu")
    prompt = np.random.default_rng(13).integers(
        0, plain.cfg.vocab_size, (B, F_PROMPT)).astype(np.int32)
    want, feed, _ = _family_run(plain, tp, prompt, None, jax_side=False)
    got, _, _ = _family_run(kern, tp, prompt, feed, jax_side=False)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_cache_spec_matches_the_prefill_cache(arch):
    """cache_spec against the prefill cache and the JAX package's spec:
    hymba's per-layer tuple (layer 0 global with max_len slots, layer 1 a
    rolling window-slot cache holding the last `window` positions at slot
    p % Sc), falcon-mamba's stacked SSM state."""
    ref, port = _family(arch, "float32")
    tp = port.init(torch.Generator().manual_seed(0), device="cpu")
    prompt = np.random.default_rng(14).integers(
        0, port.cfg.vocab_size, (B, F_PROMPT)).astype(np.int32)
    _, cache = port.prefill(tp, {"tokens": torch.from_numpy(prompt)},
                            max_len=F_MAX_LEN)
    spec = port.cache_spec(B, F_MAX_LEN)
    is_spec = lambda t: (isinstance(t, tuple) and len(t) == 2
                         and isinstance(t[0], tuple))
    want = jax.tree.leaves(ref.cache_spec(B, F_MAX_LEN), is_leaf=is_spec)
    got = jax.tree.leaves(spec, is_leaf=is_spec)
    assert [(tuple(s), tuple(l)) for s, l in got] == \
        [(tuple(s), tuple(l)) for s, l in want]
    leaves = tree_leaves(cache)
    assert [tuple(t.shape) for t in leaves] == [tuple(s) for s, _ in got]
    if arch == "falcon_mamba_7b":
        assert set(cache["main"]) == {"ssm"}
        assert cache["main"]["ssm"]["ssm"].dtype == torch.float32
        return
    assert isinstance(cache, tuple) and len(cache) == port.cfg.num_layers
    window = port.cfg.sliding_window
    full, swa = cache[0]["kv"]["pos"], cache[1]["kv"]["pos"]
    assert port.cfg.global_attn_layers == (0,)
    assert full.shape == (B, F_MAX_LEN) and swa.shape == (B, window)
    assert full[0].tolist() == (list(range(F_PROMPT))
                                + [-1] * (F_MAX_LEN - F_PROMPT))
    assert sorted(swa[0].tolist()) == list(range(F_PROMPT - window,
                                                 F_PROMPT))
    assert all(int(p) % window == s for s, p in enumerate(swa[0]))
    assert cache[1]["ssm"]["ssm"].dtype == torch.float32


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_init_matches_the_reference_tree(arch):
    """Same paths, shapes and dtypes as the JAX init (the SSM's dt_bias,
    a_log and d_skip in fp32); a_log = log(1..N) exactly as the JAX
    package draws it; dt_bias the inverse softplus of a value in
    [1e-3, 1e-1]."""
    ref, port = _family(arch, "bfloat16")
    jp = jax.tree.map(np.asarray, ref.init(jax.random.key(0)))
    tp = port.init(torch.Generator().manual_seed(0), device="cpu")
    paths = lambda t: [jax.tree_util.keystr(k) for k, _ in
                       jax.tree_util.tree_flatten_with_path(t)[0]]
    assert paths(tp) == paths(jp)
    for w, g in zip(jax.tree.leaves(jp), jax.tree.leaves(tp)):
        assert tuple(g.shape) == w.shape
        assert str(g.dtype).split(".")[-1] == w.dtype.name
    ssm = tp["layers"]["ssm"]
    np.testing.assert_array_equal(ssm["a_log"].numpy(),
                                  jp["layers"]["ssm"]["a_log"])
    dt = torch.nn.functional.softplus(ssm["dt_bias"])
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5)
    assert float(dt.max()) <= 1e-1 * (1 + 1e-5)
