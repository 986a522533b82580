"""repro_torch.serving against tests/test_serving.py and the JAX engine.

The three engine tests of test_serving.py run on the port with a torch
stub model (next token = last token + 1 mod vocab), so every assertion is
exact; `splice_row` is checked on its own, on the stacked and the hybrid
(per-layer tuple) cache layouts; the serving CLI must give exactly 6 x 8
tokens (test_system.py::test_serve_end_to_end) for Llama and Hymba, with
the decode kernel on in the config it builds; and fp32 engine runs on
``reduced(llama3_2_1b)``, ``reduced(hymba_1_5b)`` and the other families
(MoE, vision, MLA, enc-dec, SSM and StarCoder2's 9 query heads a kv head)
must produce the JAX engine's tokens on carried weights.  Everything runs on the CPU
(``device="cpu"``).
"""
import os
import subprocess
import sys
import tempfile
import textwrap
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import PilotSession  # noqa: E402
from repro_torch.core.pilot import State  # noqa: E402
from repro_torch.models.common import ParamSpec  # noqa: E402
from repro_torch.serving import ServingEngine, splice_row  # noqa: E402
from repro_torch.serving.engine import (flatten_params,  # noqa: E402
                                        sample_tokens, unflatten_params)

SRC = Path(__file__).resolve().parents[1] / "src"


class _StubModel:
    """next = (last + 1) % vocab; cache is a dict with batch axis 0."""

    def __init__(self, vocab=32, delay=0.0):
        self.cfg = SimpleNamespace(name="stub", vocab_size=vocab)
        self.vocab = vocab
        self.delay = delay

    # the engine draws the stub's one leaf, zeros, from its specs
    specs = {"w": ParamSpec((4,), (None,), "zeros", dtype=torch.float32)}

    def _step(self, last):
        logits = torch.nn.functional.one_hot(
            (last.long() + 1) % self.vocab, self.vocab).float() * 100.0
        return logits, {"last": last.to(torch.int32).reshape(-1, 1)}

    def prefill(self, params, batch, max_len):
        return self._step(batch["tokens"][:, -1])

    def decode(self, params, cache, tokens, positions):
        if self.delay:
            time.sleep(self.delay)
        return self._step(tokens[:, 0])


def _expected(prompt, gen, vocab=32):
    return [(int(prompt[-1]) + 1 + i) % vocab for i in range(gen)]


def test_engine_refill_exact_token_counts():
    """More requests than batch rows: freed rows MUST be refilled from the
    queue, and every request's output must be exact — so a row that
    serves request A then request B can't leak tokens across the splice."""
    model = _StubModel()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 32, size=4 + (i % 3)).astype(np.int32)
               for i in range(6)]
    with PilotSession(device="cpu") as s:
        s.add_pilots(1, memory_gb=0.25)
        with ServingEngine(s, model, batch_size=2, max_len=32,
                           page_tokens=4) as eng:
            eng.deploy()
            assert s.serving_engines == [eng]
            reqs = [eng.submit(p, 5) for p in prompts]
            eng.drain(timeout=60)
            for p, r in zip(prompts, reqs):
                assert r.result(timeout=5) == _expected(p, 5)
            st = eng.stats()
        assert s.serving_engines == []         # close deregisters
    assert st["completed"] == 6
    assert st["refills"] >= 4          # 6 requests through 2 rows
    assert st["tokens_served"] == 6 * 5  # exact: no padded/retired counting


def test_a_crashed_loop_fails_drain_with_its_error():
    """A replica loop that raises (here its model's decode) leaves no
    replica to serve in an unsupervised session: ``drain`` raises at once
    from that error rather than waiting out its timeout."""
    class Broken(_StubModel):
        def decode(self, params, cache, tokens, positions):
            raise MemoryError("decode failed")

    with PilotSession(device="cpu") as s:
        s.add_pilots(1, memory_gb=0.25)
        with ServingEngine(s, Broken(), batch_size=2, max_len=32) as eng:
            eng.deploy()
            eng.submit(np.arange(4, dtype=np.int32), 5)
            t0 = time.monotonic()
            with pytest.raises(RuntimeError, match="loop failed") as err:
                eng.drain(timeout=60)
            assert time.monotonic() - t0 < 30
            assert isinstance(err.value.__cause__, MemoryError)


def test_engine_inactive_rows_do_not_count_tokens():
    """Rows that finished early (short gen) or were padding in a prefill
    wave must stop sampling AND stop counting: tokens_served is exactly
    the sum of requested gen lengths."""
    model = _StubModel()
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 32, size=4).astype(np.int32)
               for _ in range(3)]
    gens = [2, 9, 5]                   # ragged: rows retire at different steps
    with PilotSession(device="cpu") as s:
        s.add_pilots(1, memory_gb=0.25)
        with ServingEngine(s, model, batch_size=4, max_len=32,
                           page_tokens=4) as eng:   # batch 4 > 3 requests
            eng.deploy()
            reqs = [eng.submit(p, g) for p, g in zip(prompts, gens)]
            eng.drain(timeout=60)
            for p, g, r in zip(prompts, gens, reqs):
                got = r.result(timeout=5)
                assert got == _expected(p, g)
                assert len(got) == g   # exactly g — not max(gens), not 0
            st = eng.stats()
    assert st["tokens_served"] == sum(gens)


def test_engine_recovers_requests_after_pilot_kill():
    """Kill a pilot mid-decode (state FAILED + volatile tiers lost): its
    in-flight requests must be recovered from the durable KV-page
    partitions and finish on the surviving replica with exact outputs and
    exact token accounting."""
    model = _StubModel(delay=0.02)     # slow decode so the kill lands mid-run
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 32, size=5).astype(np.int32)
               for _ in range(4)]
    with tempfile.TemporaryDirectory() as ckpt:
        with PilotSession(checkpoint_dir=ckpt, supervise=True,
                          device="cpu") as s:
            pilots = s.add_pilots(2, memory_gb=0.25)
            with ServingEngine(s, model, batch_size=2, max_len=64,
                               page_tokens=4) as eng:
                eng.deploy()
                reqs = [eng.submit(p, 30) for p in prompts]
                time.sleep(0.25)       # let decode get going on both pilots
                victim = next((rep.pilot for rep in eng._replicas.values()
                               if rep.active), pilots[0])
                victim.state = State.FAILED
                if victim.tier_manager is not None:
                    victim.tier_manager.lose_volatile()
                eng.drain(timeout=120)
                for p, r in zip(prompts, reqs):
                    assert r.result(timeout=10) == _expected(p, 30)
                st = eng.stats()
    assert st["completed"] == 4        # zero data loss
    assert st["recovered_requests"] >= 1
    assert st["replica_deaths"] >= 1


# -- pieces ----------------------------------------------------------------
def test_splice_row_writes_one_row_of_a_stacked_cache():
    """B > 1: the batch axis of an (L,B,S,...) leaf is 1, so the row goes
    into every layer and no other row changes."""
    cache = {"kv": {"k": torch.zeros(3, 4, 5, 2), "pos": torch.full(
        (3, 4, 5), -1, dtype=torch.int32)}}
    row = {"kv": {"k": torch.ones(3, 1, 5, 2), "pos": torch.arange(
        15, dtype=torch.int32).reshape(3, 1, 5)}}
    out = splice_row(cache, row, 2)
    assert out is cache
    assert torch.equal(cache["kv"]["k"][:, 2], torch.ones(3, 5, 2))
    assert float(cache["kv"]["k"].sum()) == 3 * 5 * 2
    assert torch.equal(cache["kv"]["pos"][:, 2:3], row["kv"]["pos"])
    assert bool((cache["kv"]["pos"][:, [0, 1, 3]] == -1).all())


def test_splice_row_at_batch_one_copies_the_whole_leaf():
    """B == 1: shapes are equal, so every layer is replaced — a narrow on
    axis 0 would have written layer 0 only."""
    cache = {"k": torch.zeros(3, 1, 4), "last": torch.zeros(1, 1)}
    row = {"k": torch.arange(12.).reshape(3, 1, 4),
           "last": torch.full((1, 1), 7.)}
    splice_row(cache, row, 0)
    assert torch.equal(cache["k"], row["k"])
    assert float(cache["last"]) == 7.0


def test_splice_row_writes_one_row_of_the_hybrid_tuple_cache():
    """The hybrid layout: a tuple of per-layer {"kv", "ssm"} dicts, batch
    on axis 0 of every leaf and each layer with its own Sc.  The row goes
    into every layer; no other row changes."""
    def layer(b, sc, fill):
        return {"kv": {"k": torch.full((b, sc, 2, 4), fill),
                       "pos": torch.full((b, sc), -1, dtype=torch.int32)},
                "ssm": {"conv": torch.full((b, 3, 8), fill),
                        "ssm": torch.full((b, 8, 4), fill)}}
    cache = (layer(4, 64, 0.0), layer(4, 32, 0.0))
    row = (layer(1, 64, 1.0), layer(1, 32, 2.0))
    row[1]["kv"]["pos"] += 7
    out = splice_row(cache, row, 1)
    assert out is cache
    for i, fill in enumerate((1.0, 2.0)):
        for name in ("k",):
            t = cache[i]["kv"][name]
            assert bool((t[1] == fill).all()) and float(t.sum()) == \
                fill * t[1].numel()
        for name in ("conv", "ssm"):
            t = cache[i]["ssm"][name]
            assert bool((t[1] == fill).all()) and float(t.sum()) == \
                fill * t[1].numel()
    assert bool((cache[1]["kv"]["pos"][1] == 6).all())
    assert bool((cache[1]["kv"]["pos"][[0, 2, 3]] == -1).all())


def test_sample_tokens_masks_inactive_rows():
    logits = torch.tensor([[0., 5., 1.], [3., 0., 0.], [0., 0., 9.]])
    active = torch.tensor([True, False, True])
    gen = torch.Generator().manual_seed(1)
    tok = sample_tokens(logits, active, gen, 0.0)
    assert tok.dtype == torch.int32 and tok.tolist() == [1, 0, 2]
    hot = sample_tokens(logits * 100, active, gen, 1.0)
    assert hot.tolist() == [1, 0, 2]


def test_flatten_params_is_sorted_and_round_trips():
    tree = {"b": {"y": torch.ones(2), "x": torch.zeros(1)}, "a": torch.ones(3)}
    flat = flatten_params(tree)
    assert [p for p, _ in flat] == [("a",), ("b", "x"), ("b", "y")]
    back = unflatten_params([p for p, _ in flat], [t for _, t in flat])
    assert back.keys() == tree.keys() and back["b"]["y"] is tree["b"]["y"]


# -- the CLI and the real model ---------------------------------------------
def _serve_cli(arch, monkeypatch):
    """The CLI at the smoke preset on the CPU -> (stats, configs built)."""
    import repro_torch.launch.serve as serve
    built = []
    real = serve.build_model
    monkeypatch.setattr(serve, "build_model",
                        lambda cfg: built.append(cfg) or real(cfg))
    stats = serve.main([
        "--arch", arch, "--preset", "smoke", "--requests", "6",
        "--batch", "3", "--prompt-len", "8", "--gen", "8",
        "--max-len", "32", "--device", "cpu"])
    return stats, built


def test_serve_cli_end_to_end_exact_tokens(monkeypatch):
    """The CLI serves exactly 6 x 8 tokens, and the config it builds has
    the decode kernel on (on the card `decode_attention_op` launches it;
    here it runs its plain version)."""
    stats, built = _serve_cli("llama3_2_1b", monkeypatch)
    assert stats["completed"] == 6
    assert stats["tokens_served"] == 6 * 8  # exact: no phantom row tokens
    assert stats["decode_steps"] > 0
    assert [c.decode_kernel for c in built] == [True]


def test_serve_cli_hymba_smoke(monkeypatch):
    """``--arch hymba_1_5b --preset smoke --device cpu``: the hybrid family
    through the same CLI, exact counts, kernel decode on."""
    stats, built = _serve_cli("hymba_1_5b", monkeypatch)
    assert stats["completed"] == 6
    assert stats["tokens_served"] == 6 * 8
    assert stats["decode_steps"] > 0
    assert [(c.parallel_ssm, c.decode_kernel) for c in built] == [(True, True)]


@pytest.mark.parametrize("arch", ["deepseek_v3_671b", "whisper_base"])
def test_serve_cli_mla_and_encdec_smoke(arch, monkeypatch):
    """``--arch deepseek_v3_671b`` (MLA + MoE) and ``--arch whisper_base``
    (enc-dec) at ``--preset smoke --device cpu``: exact counts, kernel
    decode on in the config built."""
    stats, built = _serve_cli(arch, monkeypatch)
    assert stats["completed"] == 6
    assert stats["tokens_served"] == 6 * 8
    assert stats["decode_steps"] > 0
    assert [(c.attention, bool(c.encoder_layers), c.decode_kernel)
            for c in built] == [("mla" if arch.startswith("deepseek")
                                 else "gqa", arch == "whisper_base", True)]


def test_serve_cli_layers_cuts_the_depth(monkeypatch):
    """``--layers`` serves the config cut to that many decoder layers."""
    import repro_torch.launch.serve as serve
    built = []
    real = serve.build_model
    monkeypatch.setattr(serve, "build_model",
                        lambda cfg: built.append(cfg) or real(cfg))
    stats = serve.main([
        "--arch", "deepseek_v3_671b", "--preset", "smoke", "--layers", "3",
        "--requests", "2", "--batch", "2", "--prompt-len", "4", "--gen",
        "3", "--max-len", "16", "--device", "cpu"])
    assert stats["tokens_served"] == 6
    assert [(c.num_layers, c.moe.first_k_dense) for c in built] == [(3, 1)]


@pytest.mark.parametrize("preset", ["smoke", "20m", "full"])
def test_cli_presets_decode_with_the_kernel(preset):
    from repro_torch.launch.train import scaled_config
    assert scaled_config("llama3_2_1b", preset).decode_kernel is True


def test_serving_imports_nothing_of_jax():
    code = textwrap.dedent("""
        import sys
        import repro_torch.kernels.flash_attention.ops
        import repro_torch.kernels.selective_scan.ops
        import repro_torch.models.ssm
        from repro_torch.launch.serve import main
        for arch in ("llama3_2_1b", "hymba_1_5b", "falcon_mamba_7b",
                     "starcoder2_7b"):
            st = main(["--arch", arch, "--preset", "smoke", "--requests",
                       "2", "--batch", "2", "--prompt-len", "4", "--gen",
                       "3", "--max-len", "16", "--device", "cpu"])
            assert st["tokens_served"] == 6, st
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


def _engine_tokens_match(arch, lens, max_len, spy=None, **over):
    """fp32 reduced `arch` (with `over`: config overrides, a "moe" entry
    replacing fields of the MoE part), greedy: the same params (the JAX
    init, cast to fp32 and carried over) and prompts of lengths `lens` (a
    prefill wave, then refills spliced into the batched cache) give the
    same tokens on the JAX engine and the port's.  `spy(model)` may wrap
    the port's model before it serves."""
    import dataclasses
    import jax
    import jax.numpy as jnp
    import repro.core as ref_core
    from repro.configs import get_config as ref_get_config
    from repro.configs.base import reduced as ref_reduced
    from repro.models.model import build_model as ref_build_model
    from repro.serving import ServingEngine as RefEngine

    from repro_torch.carry import params_from_numpy
    from repro_torch.configs import get_config
    from repro_torch.configs.base import reduced
    from repro_torch.models.model import build_model

    moe_over = over.pop("moe", {})
    rcfg = ref_reduced(ref_get_config(arch), dtype="float32", **over)
    pcfg = reduced(get_config(arch), dtype="float32", decode_kernel=False,
                   **over)
    if moe_over:
        rcfg = dataclasses.replace(rcfg, moe=dataclasses.replace(
            rcfg.moe, **moe_over))
        pcfg = dataclasses.replace(pcfg, moe=dataclasses.replace(
            pcfg.moe, **moe_over))
    jm, tm = ref_build_model(rcfg), build_model(pcfg)
    jp = jax.tree.map(lambda x: x.astype(jnp.float32),
                      jm.init(jax.random.key(0)))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 256, size=n).astype(np.int32) for n in lens]

    def serve(session_cls, engine_cls, model, params, **kw):
        with session_cls(**kw) as s:
            s.add_pilots(1, memory_gb=0.25)
            with engine_cls(s, model, params=params, batch_size=2,
                            max_len=max_len, page_tokens=4) as eng:
                eng.deploy()
                reqs = [eng.submit(p, 6) for p in prompts]
                eng.drain(timeout=120)
                return [r.result(timeout=5) for r in reqs], eng.stats()

    want, _ = serve(ref_core.PilotSession, RefEngine, jm, jp)
    got, st = serve(PilotSession, ServingEngine,
                    tm if spy is None else spy(tm), tp, device="cpu")
    assert got == want
    assert st["tokens_served"] == len(lens) * 6 and st["refills"] >= 3


def test_engine_tokens_equal_the_jax_engine_on_carried_weights():
    """Reduced Llama (see _engine_tokens_match)."""
    _engine_tokens_match("llama3_2_1b", (6, 6, 9, 7, 6), max_len=32)


def test_hymba_engine_tokens_equal_the_jax_engine_on_carried_weights():
    """Reduced Hymba on the refill path: prompts past its window of 32, so
    the spliced rows carry rolled sliding-window caches beside the global
    layer's and the SSM state (see _engine_tokens_match)."""
    _engine_tokens_match("hymba_1_5b", (36, 36, 40, 34, 38), max_len=64)


@pytest.mark.parametrize("cf", [1.25, 8.0])
def test_mixtral_engine_tokens_equal_the_jax_engine_on_carried_weights(cf):
    """Reduced Mixtral (MoE) with a rolling window of 8, as
    tests/test_serving.py serves it, at capacity factors 1.25 (one slot
    per expert when a decode step regroups the two rows) and 8.0: prompts
    past the window and decode past it (see _engine_tokens_match)."""
    _engine_tokens_match("mixtral_8x22b", (10, 10, 13, 9, 12), max_len=32,
                         sliding_window=8, moe={"capacity_factor": cf})


def test_vision_engine_tokens_equal_the_jax_engine_on_carried_weights():
    """Reduced InternVL2: the engine feeds zero patch embeddings and offsets
    every decode position by the 4 vision tokens, as the JAX engine does;
    the first decode of a row is at position vision + prompt length."""
    import dataclasses
    firsts = []

    def spy(model):
        inner = model.decode

        def decode(params, cache, tokens, positions):
            firsts.append(positions.tolist())
            return inner(params, cache, tokens, positions)
        return dataclasses.replace(model, decode=decode)

    lens = (6, 6, 9, 7, 6)
    _engine_tokens_match("internvl2_2b", lens, max_len=32, spy=spy)
    # the wave of two 6-token prompts decodes first at 4 + 6
    assert firsts[0] == [4 + 6, 4 + 6], firsts[0]


@pytest.mark.parametrize("cf", [1.25, 8.0])
def test_mla_engine_tokens_equal_the_jax_engine_on_carried_weights(cf):
    """Reduced DeepSeek-V3 (a dense MLA layer, then an MoE layer with the
    sigmoid router and a shared expert) at capacity factors 1.25 and 8.0:
    refills spliced into the batched latent caches of both stacks (see
    _engine_tokens_match)."""
    _engine_tokens_match("deepseek_v3_671b", (6, 6, 9, 7, 6), max_len=32,
                         moe={"capacity_factor": cf})


def test_encdec_engine_tokens_equal_the_jax_engine_on_carried_weights():
    """Reduced Whisper: the engine feeds zero frames, as the JAX engine
    does; refills splice the self-attention cache and the cross (k, v)
    tuple into their rows (see _engine_tokens_match)."""
    _engine_tokens_match("whisper_base", (6, 6, 9, 7, 6), max_len=32)


def test_ssm_engine_tokens_equal_the_jax_engine_on_carried_weights():
    """Reduced Falcon-Mamba (the SSM family: no attention, the stacked
    conv history and state of every layer the whole cache): refills
    splice a prompt's conv history and state into their row of the
    batched cache (see _engine_tokens_match)."""
    _engine_tokens_match("falcon_mamba_7b", (6, 6, 9, 7, 6), max_len=32)


def test_starcoder2_engine_tokens_equal_the_jax_engine_on_carried_weights():
    """Reduced StarCoder2 at its published ratio of 9 query heads a kv
    head (18/2, H=16) and its two-matrix tanh-GELU FFN: a wave, then
    refills spliced into the batched cache (see _engine_tokens_match)."""
    _engine_tokens_match("starcoder2_7b", (6, 6, 9, 7, 6), max_len=32,
                         num_heads=18, num_kv_heads=2)


def test_port_modules_and_chip_smoke_import_nothing_of_jax():
    """Every module of src/repro_torch imports (in a fresh interpreter)
    without pulling in jax or the JAX package, and neither chip_smoke.py
    nor any of the ported examples (examples/torch/*.py) names either in
    an import; the CLI serves the MoE, vision, MLA and enc-dec configs."""
    import ast
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        from repro_torch.launch.serve import main
        for arch in ("mixtral_8x22b", "internvl2_2b", "deepseek_v3_671b",
                     "whisper_base"):
            st = main(["--arch", arch, "--preset", "smoke", "--requests",
                       "2", "--batch", "2", "--prompt-len", "4", "--gen",
                       "3", "--max-len", "16", "--device", "cpu"])
            assert st["tokens_served"] == 6, st
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "repro", "ml_dtypes"))
        assert not bad, bad
        print(len(names))
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(SRC)})
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip().splitlines()[-1]) > 40
    examples = sorted((SRC.parent / "examples" / "torch").glob("*.py"))
    assert len(examples) == 6, examples
    for path in [SRC.parent / "chip_smoke.py"] + examples:
        roots = set()
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                roots |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.module:
                roots.add(node.module.split(".")[0])
        assert "repro_torch" in roots, path
        assert not roots & {"jax", "jaxlib", "repro"}, (path, roots)
