"""repro_torch's training stack against the JAX package's, on the CPU.

- For each family (dense GQA, hybrid, SSM, MoE, MLA with MTP, enc-dec,
  vision) on ``reduced(cfg)`` in fp32: the same params (the JAX init,
  cast to fp32 and carried over with ``carry.params_from_numpy``) and the
  same numpy batch give the same ``compute_loss`` metrics (rtol 1e-5) and
  the same gradient in every leaf (rtol 1e-4, atol 2e-6), as
  ``jax.value_and_grad`` takes it.  The stacked layer leaves are first
  rescaled to a 1/sqrt(fan-in) scale on the numpy side: the reference's
  init takes a stacked leaf's layer count as its fan-in, activations then
  reach hundreds, and either package's fp32 gradients move by up to 3e-4
  of their norm under a change of summation order (measured against a
  float64 run of the JAX package), which no elementwise check survives.
  At this scale the largest gap measured was 1.04x (rtol 1e-4, atol
  1e-6), on one near-zero element of the MoE router's gradient.
- 3 train steps with 1 and 2 microbatches match the JAX package's
  ``make_train_step`` (metrics at rtol 1e-5, params at rtol 1e-4, atol
  1e-6).
- remat full, dots and none give the same gradients, and dots recomputes
  none of the matmuls that full recomputes.
- the training path runs no kernel op (each ``*_op`` made to raise), the
  serving prefill still calls ``flash_attention_op``, and each op refuses
  an input that requires grad.
- the cases of tests/test_system.py's training tests, through
  ``repro_torch.launch.train.main([..., "--device", "cpu"])``, with the
  same assertions, and a subprocess that checks the training CLI loads
  nothing of JAX or the JAX package.
- one ``gpu`` test: 3 steps on the card against the same steps on the
  CPU, from the same fan-in-scaled params (it imports nothing of JAX:
  ``pytest --noconftest -m gpu``).
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.carry import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import (ParallelConfig,  # noqa: E402
                                      TrainConfig, reduced)
from repro_torch.models.common import (tree_leaves, tree_map,  # noqa: E402
                                       tree_unflatten)
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.train import steps  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
FAMILIES = ["llama3_2_1b", "hymba_1_5b", "falcon_mamba_7b", "mixtral_8x22b",
            "deepseek_v3_671b", "whisper_base", "internvl2_2b"]
STEP_CFG = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10)


def _batch(cfg, b=2, s=24, seed=0):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.vision_tokens:
        out["patch_embeds"] = rng.normal(
            0, 0.5, (b, cfg.vision_tokens, cfg.vision_embed_dim)).astype(
            np.float32)
    if cfg.encoder_layers:
        out["frames"] = rng.normal(
            0, 0.5, (b, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
    return out


def _fan_in_scale(spec) -> float:
    """The factor that takes a stacked "scaled" leaf from the reference's
    draw (its fan-in taken as the layer count) to 1/sqrt(its input
    width)."""
    if spec.init == "scaled" and spec.logical[0] == "layers":
        return float(np.sqrt(spec.shape[0] / spec.shape[1]))
    return 1.0


def _torch_batch(batch, device="cpu"):
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def _models(arch, **over):
    """(JAX model, port model, the JAX init in fp32 as numpy, rescaled)."""
    import jax
    from repro.configs import get_config as ref_get_config
    from repro.configs.base import reduced as ref_reduced
    from repro.models.common import ParamSpec as RefParamSpec
    from repro.models.model import build_model as ref_build_model

    over = dict(dtype="float32", **over)
    ref = ref_build_model(ref_reduced(ref_get_config(arch), **over))
    port = build_model(reduced(get_config(arch), **over))

    params = jax.tree.map(
        lambda spec, leaf: np.asarray(leaf, np.float32)
        * np.float32(_fan_in_scale(spec)),
        ref.specs, ref.init(jax.random.key(0)),
        is_leaf=lambda x: isinstance(x, RefParamSpec))
    return ref, port, params


# -- gradients, per family -----------------------------------------------------
@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_match_the_reference(arch):
    import jax
    import jax.numpy as jnp
    from repro.configs.base import TrainConfig as RefTrainConfig
    from repro.train.steps import compute_loss as ref_compute_loss

    ref, port, params = _models(arch)
    batch = _batch(port.cfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (_, want), ref_grads = jax.value_and_grad(
        lambda p: ref_compute_loss(ref, p, jbatch, RefTrainConfig()),
        has_aux=True)(jax.tree.map(jnp.asarray, params))
    got, grads = steps.loss_and_grads(port, params_from_numpy(params, "cpu"),
                                      _torch_batch(batch), TrainConfig())
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(ref_grads)[0]]
    leaves = tree_leaves(grads)
    assert len(leaves) == len(paths)
    for path, g, w in zip(paths, leaves, jax.tree.leaves(ref_grads)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=2e-6, err_msg=path)


# -- train steps ---------------------------------------------------------------
@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_steps_match_the_reference(microbatches):
    import jax
    import jax.numpy as jnp
    from repro.configs.base import ParallelConfig as RefParallelConfig
    from repro.configs.base import TrainConfig as RefTrainConfig
    from repro.optim.adamw import adamw_init as ref_adamw_init
    from repro.train import steps as ref_steps

    ref, port, params = _models("llama3_2_1b")
    ref_step = ref_steps.make_train_step(
        ref, RefParallelConfig(microbatches=microbatches),
        RefTrainConfig(**STEP_CFG))
    step = steps.make_train_step(port, ParallelConfig(
        microbatches=microbatches), TrainConfig(**STEP_CFG))
    jp = jax.tree.map(jnp.asarray, params)
    rstate = ref_steps.TrainState(jp, ref_adamw_init(jp))
    tp = params_from_numpy(params, "cpu")
    state = steps.TrainState(tp, steps.adamw_init(tp))
    for i in range(3):
        batch = _batch(port.cfg, b=4, s=16, seed=10 + i)
        rstate, want = ref_step(rstate, {k: jnp.asarray(v)
                                         for k, v in batch.items()})
        state, got = step(state, _torch_batch(batch))
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       rtol=1e-5, atol=1e-8, err_msg=k)
    assert int(state.opt_state.count) == 3
    for g, w in zip(tree_leaves(state.params), jax.tree.leaves(rstate.params)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-6)


def _count_matmuls():
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                        torch.ops.aten.addmm.default):
                Count.n += 1
            return func(*args, **(kwargs or {}))
    return Count


@pytest.mark.parametrize("arch", ["llama3_2_1b", "whisper_base",
                                  "mixtral_8x22b"])
def test_remat_policies_give_the_same_gradients(arch):
    grads, matmuls = {}, {}
    for remat in ("full", "dots", "none"):
        model = build_model(reduced(get_config(arch), dtype="float32",
                                    remat=remat))
        params = tree_map(lambda t: t.float(), model.init(
            torch.Generator().manual_seed(0), device="cpu"))
        counter = _count_matmuls()
        with counter():
            _, g = steps.loss_and_grads(model, params, _torch_batch(
                _batch(model.cfg)), TrainConfig())
        grads[remat], matmuls[remat] = tree_leaves(g), counter.n
    for remat in ("dots", "none"):
        for a, b in zip(grads["full"], grads[remat]):
            torch.testing.assert_close(b, a, rtol=0, atol=0)
    # "full" recomputes each layer's matmuls in the backward pass; "dots"
    # keeps them, as "none" does (the attention chunks are checkpointed on
    # every policy)
    assert matmuls["dots"] == matmuls["none"] < matmuls["full"], matmuls


# -- the training path runs no kernel --------------------------------------------
OPS = [("repro_torch.models.attention", "flash_attention_op"),
       ("repro_torch.models.attention", "decode_attention_op"),
       ("repro_torch.models.ssm", "selective_scan_op"),
       ("repro_torch.core.analytics", "kmeans_assign_op")]


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_forward_runs_no_kernel_op(arch, monkeypatch):
    import importlib

    def refuse(*args, **kwargs):
        raise AssertionError("the training path called a forward-only op")

    for mod, name in OPS:
        monkeypatch.setattr(importlib.import_module(mod), name, refuse)
    model = build_model(reduced(get_config(arch)))
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    metrics, grads = steps.loss_and_grads(
        model, params, _torch_batch(_batch(model.cfg)), TrainConfig())
    assert np.isfinite(float(metrics["total_loss"]))
    assert any(float(g.float().abs().max()) > 0 for g in tree_leaves(grads))


def test_serving_prefill_still_calls_the_flash_op(monkeypatch):
    import repro_torch.models.attention as attn
    calls = []
    real = attn.flash_attention_op

    def spy(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(attn, "flash_attention_op", spy)
    model = build_model(reduced(get_config("llama3_2_1b")))
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    model.prefill(params, {"tokens": torch.zeros(2, 8, dtype=torch.int32)},
                  max_len=16)
    assert len(calls) == model.cfg.num_layers


def _op_inputs(name):
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g)
    if name == "flash_attention_op":
        return (r(1, 8, 4, 16), r(1, 8, 2, 16), r(1, 8, 2, 16)), {}
    if name == "decode_attention_op":
        return (r(2, 4, 16), r(2, 8, 2, 16), r(2, 8, 2, 16),
                torch.arange(8, dtype=torch.int32).expand(2, 8).contiguous(),
                torch.full((2,), 7, dtype=torch.int32)), {}
    if name == "selective_scan_op":
        return (r(1, 8, 6), torch.rand(1, 8, 6, generator=g), -torch.rand(
            6, 4, generator=g), r(1, 8, 4), r(1, 8, 4), r(6)), {}
    return (r(50, 3), r(4, 3)), {}


@pytest.mark.parametrize("path", ["flash_attention", "decode_attention",
                                  "selective_scan", "kmeans"])
def test_forward_only_op_refuses_an_input_that_requires_grad(path):
    import importlib
    name = {"kmeans": "kmeans_assign_op"}.get(path, f"{path}_op")
    op = getattr(importlib.import_module(f"repro_torch.kernels.{path}.ops"),
                 name)
    args, kw = _op_inputs(name)
    op(*args, **kw)                           # nothing requires grad: runs
    args[0].requires_grad_(True)
    for impl in ("auto", "ref", "cuda"):      # every route, before dispatch
        with pytest.raises(RuntimeError, match="forward-only"):
            op(*args, impl=impl, **kw)
    with torch.no_grad():
        op(*args, **kw)                       # grad mode off: runs


# -- the training CLI (tests/test_system.py's cases) -----------------------------
def _main(tmp_path, *argv):
    from repro_torch.launch.train import main
    return main(list(argv) + ["--ckpt-dir", str(tmp_path), "--device",
                              "cpu"])


def test_train_loss_decreases(tmp_path):
    """Tiny LM, 60 steps on the real pipeline: loss must drop measurably
    below the corpus' unigram entropy (the bigram structure is learnable)."""
    final = _main(tmp_path, "--arch", "llama3_2_1b", "--preset", "smoke",
                  "--steps", "60", "--batch", "8", "--seq", "64", "--lr",
                  "2e-2", "--ckpt-every", "50", "--log-every", "50")
    assert final < 5.2, final  # ln(512)=6.24 unigram ~5.6; must beat unigram


def test_train_recovers_from_injected_failure(tmp_path, capsys):
    from repro_torch.checkpoint.checkpoint import CheckpointManager
    from repro_torch.launch.train import scaled_config
    final = _main(tmp_path, "--arch", "llama3_2_1b", "--preset", "smoke",
                  "--steps", "30", "--batch", "4", "--seq", "32",
                  "--ckpt-every", "10", "--failure-at", "15", "--log-every",
                  "100")
    assert np.isfinite(final)
    assert "recovered at step 10" in capsys.readouterr().out
    # checkpoint dir has the final step
    cfg = scaled_config("llama3_2_1b", "smoke")
    ckpt = CheckpointManager(Path(tmp_path) / cfg.name)
    assert ckpt.latest_step() == 30


def test_train_microbatched_matches_shapes(tmp_path):
    final = _main(tmp_path, "--arch", "llama3_2_1b", "--preset", "smoke",
                  "--steps", "6", "--batch", "8", "--seq", "32",
                  "--microbatches", "2", "--log-every", "100")
    assert np.isfinite(final)


def test_train_int8_opt_state(tmp_path):
    final = _main(tmp_path, "--arch", "llama3_2_1b", "--preset", "smoke",
                  "--steps", "6", "--batch", "4", "--seq", "32",
                  "--opt-dtype", "int8", "--log-every", "100")
    assert np.isfinite(final)


@pytest.mark.parametrize("arch", ["falcon_mamba_7b", "mixtral_8x22b",
                                  "whisper_base"])
def test_train_other_families_smoke(arch, tmp_path):
    final = _main(tmp_path, "--arch", arch, "--preset", "smoke", "--steps",
                  "4", "--batch", "2", "--seq", "32", "--log-every", "100")
    assert np.isfinite(final)


def test_training_cli_imports_nothing_of_jax(tmp_path):
    code = textwrap.dedent(f"""
        import sys
        from repro_torch.launch.train import main
        loss = main(["--preset", "smoke", "--steps", "2", "--batch", "2",
                     "--seq", "16", "--device", "cpu", "--ckpt-dir",
                     {str(tmp_path)!r}])
        assert loss == loss, loss
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "repro", "ml_dtypes"))
        assert not bad, bad
        print("ok")
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(SRC)})
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "ok"


# -- the card ------------------------------------------------------------------
@pytest.mark.gpu
def test_train_steps_on_the_card_match_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    model = build_model(reduced(get_config("llama3_2_1b"), dtype="float32"))
    drawn = model.init(torch.Generator().manual_seed(0), device="cpu")
    # at the fan-in scale of the parity tests: on the reference's draw the
    # two devices' summation orders move the grad norm by 3e-5
    init = tree_unflatten(drawn, [
        t.float() * _fan_in_scale(spec) for spec, t in
        zip(tree_leaves(model.specs), tree_leaves(drawn))])
    runs = {}
    for dev in ("cpu", "cuda"):
        # a copy on each side: the step updates its state in place
        params = tree_map(lambda t: t.to(dev, copy=True), init)
        state = steps.TrainState(params, steps.adamw_init(params))
        step = steps.make_train_step(model, ParallelConfig(),
                                     TrainConfig(**STEP_CFG))
        for i in range(3):
            state, metrics = step(state, _torch_batch(
                _batch(model.cfg, b=4, s=16, seed=10 + i), dev))
        runs[dev] = (metrics, [t.cpu() for t in tree_leaves(state.params)])
    for k in runs["cpu"][0]:
        torch.testing.assert_close(runs["cuda"][0][k].cpu(),
                                   runs["cpu"][0][k], rtol=1e-5, atol=1e-7)
    for a, b in zip(runs["cuda"][1], runs["cpu"][1]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)
