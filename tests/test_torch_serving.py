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
import collections
import os
import re
import subprocess
import sys
import tempfile
import textwrap
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import PilotSession  # noqa: E402
from repro_torch.core.pilot import State  # noqa: E402
from repro_torch.models.common import ParamSpec  # noqa: E402
from repro_torch.serving import ServingEngine, spans, splice_row  # noqa: E402
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
                admitted = {r.rid: r.t_admit for r in reqs if r.t_admit}
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
    _assert_stamps_in_order(reqs)
    # a request recovered from a row keeps its first admission
    assert any(reqs[rid].recoveries for rid in admitted)
    assert all(reqs[rid].t_admit == t for rid, t in admitted.items())


def _assert_stamps_in_order(reqs):
    for r in reqs:
        assert r.t_submit <= r.t_admit <= r.t_first <= r.t_done, r
        assert r.queue_s == r.t_admit - r.t_submit
        assert r.ttft_s == r.t_first - r.t_submit


# -- spans ------------------------------------------------------------------
def _serve_stub(prompts, gens, record, batch=2, page_tokens=4):
    """Serve `prompts` on one pilot with the stub model -> (requests,
    the span recording or None)."""
    rec = spans.start() if record else None
    try:
        with PilotSession(device="cpu") as s:
            s.add_pilots(1, memory_gb=0.25)
            with ServingEngine(s, _StubModel(), batch_size=batch, max_len=32,
                               page_tokens=page_tokens) as eng:
                eng.deploy()
                reqs = [eng.submit(p, g) for p, g in zip(prompts, gens)]
                eng.drain(timeout=60)
    finally:
        if record:
            spans.stop()
    for p, g, r in zip(prompts, gens, reqs):
        assert r.result(timeout=5) == _expected(p, g)
    _assert_stamps_in_order(reqs)
    return reqs, rec


# distinct prompt lengths: the first wave admits one request, so every
# request enters a row through one refill of its own
_PROMPTS = [np.arange(3 + i, dtype=np.int32) % 32 for i in range(5)]
_GENS = [3, 9, 5, 4, 8]


def test_spans_off_record_nothing_and_leave_tokens_exact():
    assert spans._current is None
    assert spans.span("pass", 1) is spans.span("decode") is spans._OFF
    _serve_stub(_PROMPTS, _GENS, record=False)
    assert spans._current is None


def test_spans_of_each_pass_in_order_with_their_parents():
    reqs, rec = _serve_stub(_PROMPTS, _GENS, record=True)
    assert rec.dropped == 0 and spans._current is None
    by_id = {r.id: r for r in rec.records}
    passes = [r for r in rec.records if r.name == "pass"]
    assert passes and len({r.tid for r in passes}) == 1
    decoded = 0
    for p in passes:
        kids = sorted((r for r in rec.records if r.parent == p.id),
                      key=lambda r: r.t0_ns)
        names = " ".join(r.name for r in kids)
        assert re.fullmatch(r"admit( refill)*( sample retire( decode)?)?",
                            names), names
        decoded += names.endswith("decode")
        assert all(p.t0_ns <= k.t0_ns <= k.t1_ns <= p.t1_ns for k in kids)
        assert all(k.tid == p.tid for k in kids)
    assert decoded == sum(r.name == "decode" for r in rec.records) > 0
    # each request is refilled once, under its own rid
    refills = [r.key for r in rec.records if r.name == "refill"]
    assert sorted(refills) == sorted(r.rid for r in reqs)
    # a flush every `page_tokens` tokens and at the last, under `retire`
    flushes = [r for r in rec.records if r.name == "flush_pages"]
    assert all(by_id[f.parent].name == "retire" for f in flushes)
    assert collections.Counter(f.key for f in flushes) == {
        r.rid: -(-g // 4) for r, g in zip(reqs, _GENS)}
    # deploy, its three children, and the runtime's build on the loop
    # thread
    once = collections.Counter(r.name for r in rec.records
                               if r.name.startswith(("deploy", "runtime")))
    assert once == {"deploy": 1, "deploy.shard": 1, "deploy.place": 1,
                    "deploy.pin": 1, "runtime.build": 1}
    deploy = next(r for r in rec.records if r.name == "deploy")
    assert {by_id[r.parent].name for r in rec.records if r.name in (
        "deploy.shard", "deploy.place", "deploy.pin")} == {"deploy"}
    build = next(r for r in rec.records if r.name == "runtime.build")
    assert build.parent is None and build.tid == passes[0].tid != deploy.tid
    # on one pilot its loop starts after the pin: the round trip's four
    # spans follow each other
    trip = [next(r for r in rec.records if r.name == n) for n in (
        "deploy.shard", "deploy.place", "deploy.pin", "runtime.build")]
    assert all(a.t1_ns <= b.t0_ns for a, b in zip(trip, trip[1:]))


def test_span_recording_nests_per_thread_caps_and_stops(monkeypatch):
    monkeypatch.setattr(spans, "CAP", 3)
    rec = spans.start()
    try:
        with pytest.raises(RuntimeError, match="already on"):
            spans.start()
        with spans.span("a", 7):
            t = threading.Thread(target=lambda: spans.span("t").__enter__()
                                 .__exit__(None, None, None))
            t.start()
            t.join(timeout=10)
            assert not t.is_alive()
            with spans.span("b"):
                pass
        with spans.span("c"):
            pass
    finally:
        assert spans.stop() is rec
    assert spans.stop() is None
    t_rec, b, a = rec.records
    assert (t_rec.name, t_rec.parent) == ("t", None)   # its own thread's top
    assert (b.name, b.parent, a.name, a.key, a.parent) == (
        "b", a.id, "a", 7, None)
    assert rec.dropped == 1                              # "c", over the cap


def test_span_clock_maps_onto_the_profilers():
    """A span around a `record_function` block, mapped through the
    recording's anchor, holds the profiler's event to within 1 ms."""
    from torch.profiler import ProfilerActivity, profile, record_function
    rec = spans.start()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with spans.span("outer"):
                with record_function("inner"):
                    time.sleep(0.005)
    finally:
        spans.stop()
    ev = next(e for e in prof.profiler.kineto_results.events()
              if e.name() == "inner")
    (sp,) = rec.records
    perf, unix = rec.anchor
    a, b = sp.t0_ns - perf + unix, sp.t1_ns - perf + unix
    assert a - 1_000_000 <= ev.start_ns()
    assert ev.start_ns() + ev.duration_ns() <= b + 1_000_000
    assert ev.duration_ns() >= 5_000_000


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


def test_serve_cli_end_to_end_exact_tokens(monkeypatch, capsys):
    """The CLI serves exactly 6 x 8 tokens, and the config it builds has
    the decode kernel on (on the card `decode_attention_op` launches it;
    here it runs its plain version); its line ends with the requests'
    mean queue wait and 95th-percentile time to first token."""
    stats, built = _serve_cli("llama3_2_1b", monkeypatch)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert re.search(r", mean queue wait \d+ms, p95 first token \d+ms$",
                     line), line
    assert 0 <= stats["queue_wait_ms"] / 1e3 <= stats["ttft_p95_s"]
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


# -- the decode step's CUDA graphs (models/decode_graphs.py) ----------------

def _decode_model(arch):
    """reduced `arch` in fp32 on the CPU, its params, and a prefill of 2
    prompts of 6 tokens -> (model, params, prompts, logits, cache)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import reduced
    from repro_torch.models.model import build_model
    model = build_model(reduced(get_config(arch), dtype="float32"))
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    prompts = torch.from_numpy(np.random.default_rng(3).integers(
        0, model.cfg.vocab_size, (2, 6)).astype(np.int32))
    logits, cache = model.prefill(params, {"tokens": prompts}, 32)
    return model, params, prompts, logits, cache


@pytest.mark.parametrize("arch", ["llama3_2_1b", "falcon_mamba_7b"])
def test_decode_on_the_cpu_is_the_eager_step(arch):
    """On the CPU `decode` takes the eager path: 3 steps give, bit for bit,
    the logits and cache of the eager step (``decode_graphs.step``) on a
    copy of the cache, return the very cache they were given, capture no
    graph, and end at the logits a prefill of the whole sequence gives."""
    from repro_torch.models.common import tree_leaves, tree_map
    model, params, prompts, logits, cache = _decode_model(arch)
    twin = tree_map(torch.clone, cache)
    twin_logits, seq = logits, prompts
    pos = torch.full((2,), 6, dtype=torch.int32)
    for _ in range(3):
        tok = logits.argmax(-1).to(torch.int32)[:, None]
        logits, out = model.decode(params, cache, tok, pos)
        twin_logits, twin = model.decode_graphs.step(params, twin, tok, pos)
        assert out is cache
        assert torch.equal(logits, twin_logits)
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(cache),
                                                     tree_leaves(twin)))
        seq, pos = torch.cat([seq, tok], 1), pos + 1
    whole, _ = model.prefill(params, {"tokens": seq}, 32)
    torch.testing.assert_close(logits, whole, rtol=1e-4, atol=1e-4)
    graphs = model.decode_graphs
    assert (graphs.captures, graphs.replays, len(graphs._graphs)) == (0, 0, 0)


@pytest.mark.parametrize("model", ["stub", "llama3_2_1b"])
def test_engine_stats_count_no_decode_graph_on_the_cpu(model, monkeypatch):
    """`engine.stats()` reports the decode graphs' captures and replays: 0
    for a stub model, which keeps none, and 0 for a real model on the CPU
    (the serving CLI's stats), which decodes eagerly."""
    if model == "stub":
        with PilotSession(device="cpu") as s:
            s.add_pilots(1, memory_gb=0.25)
            with ServingEngine(s, _StubModel(), batch_size=2,
                               max_len=32) as eng:
                eng.deploy()
                req = eng.submit(np.array([1, 2, 3], np.int32), 4)
                eng.drain(timeout=60)
                st = eng.stats()
        assert req.result(timeout=5) == _expected([1, 2, 3], 4)
    else:
        st, _ = _serve_cli(model, monkeypatch)
        assert st["decode_steps"] > 0
    assert (st["decode_graph_captures"], st["decode_graph_replays"]) == (0, 0)


@pytest.mark.parametrize("case", ["card", "sharding_context", "cpu"])
def test_decode_graph_engages_only_on_a_card_without_a_mesh(case):
    """The graph engages on a CUDA device with no sharding context; under
    a ``sharding_context`` (a pilot mesh: its collectives) or on the CPU
    the step runs eagerly."""
    from repro_torch.models import decode_graphs
    from repro_torch.parallel.sharding import AxisRules, sharding_context
    tokens = (torch.zeros((2, 1), dtype=torch.int32) if case == "cpu"
              else SimpleNamespace(device=torch.device("cuda")))
    if case == "sharding_context":
        with sharding_context(SimpleNamespace(), AxisRules()):
            assert not decode_graphs.engages(tokens)
    else:
        assert decode_graphs.engages(tokens) is (case == "card")


def test_graph_key_tells_caches_of_one_shape_apart_by_address():
    """A graph belongs to the memory it reads and writes: two caches of one
    shape at different addresses have different keys; the same cache and
    params, with new tokens and positions of the same shape, the same
    key; another batch shape another key."""
    from repro_torch.models.common import tree_map
    from repro_torch.models.decode_graphs import graph_key
    _, params, _, _, cache = _decode_model("llama3_2_1b")
    other = tree_map(torch.clone, cache)
    tok, pos = torch.zeros((2, 1), dtype=torch.int32), torch.zeros(
        2, dtype=torch.int32)
    key = graph_key(params, cache, tok, pos)
    assert graph_key(params, other, tok, pos) != key
    assert graph_key(params, cache, tok + 1, pos + 3) == key
    assert graph_key(params, cache, tok[:1], pos[:1]) != key


def test_decode_graphs_apply_the_step_once_and_drop_with_the_cache(
        monkeypatch):
    """The graph bookkeeping, with a stand-in for the capture (a 'graph'
    whose replay runs the eager step on the static inputs): a miss applies
    the step once, eagerly, and records (runs nothing); later calls
    replay, copying their inputs in; the tokens follow the eager step's,
    the launches a capture recorded are added on each replay, at most
    MAX_GRAPHS graphs are kept, and a freed cache drops its graph."""
    import gc
    import weakref
    from repro_torch import kernels
    from repro_torch.models import decode_graphs
    from repro_torch.models.common import tree_map

    class FakeKernel:               # a kernel wrapper's module counters
        LAUNCHES = 0
        _count_lock = threading.Lock()

    model, params, _, logits0, cache = _decode_model("falcon_mamba_7b")
    graphs = model.decode_graphs
    step = graphs.step

    def counted_step(*args):
        kernels.count_launch(FakeKernel, "LAUNCHES")
        return step(*args)

    def capture(self, params, cache, tokens, positions):
        st_tok, st_pos = tokens.clone(), positions.clone()
        with kernels.recorded_launches() as launches:
            kernels.count_launch(FakeKernel, "LAUNCHES")   # recorded only
        out = torch.empty_like(logits0)
        # a CUDA graph holds addresses, not tensors: weak references here
        refs = tree_map(weakref.ref, cache)
        graph = SimpleNamespace(replay=lambda: out.copy_(step(
            params, tree_map(lambda r: r(), refs), st_tok, st_pos)[0]))
        return decode_graphs._Graph(graph, st_tok, st_pos, out, launches)

    monkeypatch.setattr(graphs, "step", counted_step)
    monkeypatch.setattr(decode_graphs.DecodeGraphs, "_capture", capture)
    monkeypatch.setattr(decode_graphs, "engages", lambda tokens: True)
    eager = tree_map(torch.clone, cache)
    pos = torch.full((2,), 6, dtype=torch.int32)
    logits, want = logits0, logits0
    for t in range(5):
        tok = logits.argmax(-1).to(torch.int32)[:, None]
        assert torch.equal(tok, want.argmax(-1).to(torch.int32)[:, None])
        logits, out = model.decode(params, cache, tok, pos)
        want, eager = step(params, eager, tok, pos)
        assert out is cache and torch.equal(logits, want)
        assert torch.equal(cache["main"]["ssm"]["ssm"],
                           eager["main"]["ssm"]["ssm"])
        pos = pos + 1
    assert (graphs.captures, graphs.replays) == (1, 4)
    assert FakeKernel.LAUNCHES == 5          # the eager call and 4 replays
    caches = [tree_map(torch.clone, cache)
              for _ in range(decode_graphs.MAX_GRAPHS + 1)]
    for c in caches:
        model.decode(params, c, tok, pos)
    assert len(graphs._graphs) == decode_graphs.MAX_GRAPHS
    assert graphs.captures == 2 + decode_graphs.MAX_GRAPHS
    # the least recently used went: the first cache's and the next one's
    assert list(graphs._graphs) == [decode_graphs.graph_key(
        params, c, tok, pos) for c in caches[1:]]
    del caches, c
    gc.collect()
    assert len(graphs._graphs) == 0
