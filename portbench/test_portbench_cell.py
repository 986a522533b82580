"""A whole run of a tiny cell on the CPU: the harness's look for a card
skipped, the rest driven as on the card.  A sound run is correct; each
fault planted in the timed path makes it incorrect; the float8 control,
in the program's place, makes it incorrect; and the run loads nothing of
JAX or of ``repro``."""
import json
import shutil
import subprocess
import sys
import time

import pytest
import torch

from portbench.conftest import ROOT, TINY_LIMIT
from portbench.harness import cell, check
from repro_torch.models.common import tree_leaves
from repro_torch.serving import engine as engine_mod


def _run(root, faults=None, control=False, seed=2**31 + 17):
    out = cell.run("tiny.mix", seed, 1.0, False, "cpu",
                   t_start=time.perf_counter(), root=root, faults=faults,
                   control=control)
    return out, check.passed(out["checks"])


def stale_state(decode, params, cache, tokens, positions):
    """A decode step that leaves its cache or state as it found it."""
    saved = [t.clone() for t in tree_leaves(cache)]
    logits, cache = decode(params, cache, tokens, positions)
    for t, s in zip(tree_leaves(cache), saved):
        t.copy_(s)
    return logits, cache


def half_batch(decode, params, cache, tokens, positions):
    """A decode step whose second half of rows gets the first half's."""
    logits, cache = decode(params, cache, tokens, positions)
    h = logits.shape[0] // 2
    logits[h:2 * h] = logits[:h]
    return logits, cache


@pytest.mark.parametrize("family", ["dense", "ssm"])
def test_a_sound_run_is_correct(tiny_root, family):
    out, ok = _run(tiny_root(family))
    assert ok, out["checks"]
    run = out["run"]
    assert run.delta["tokens_served"] > 0 and run.latencies
    assert out["checks"]["tokens_compared"]["value"] >= 30
    assert out["checks"]["max_logit_gap"]["value"] <= TINY_LIMIT


@pytest.mark.parametrize("family", ["dense", "ssm"])
@pytest.mark.parametrize("fault", ["stale_state", "half_batch"])
def test_a_broken_decode_is_not_correct(tiny_root, family, fault):
    faults = {"decode": {"stale_state": stale_state,
                         "half_batch": half_batch}[fault]}
    out, ok = _run(tiny_root(family), faults=faults)
    assert not ok, out["checks"]
    assert out["checks"]["max_logit_gap"]["value"] > TINY_LIMIT


@pytest.mark.parametrize("family", ["dense", "ssm"])
def test_an_altered_token_is_not_correct(tiny_root, family, monkeypatch):
    sample = engine_mod.sample_tokens

    def altered(logits, active, *a, **k):
        tok = sample(logits, active, *a, **k)
        return torch.where(active, (tok + 1) % logits.shape[-1], tok)

    monkeypatch.setattr(engine_mod, "sample_tokens", altered)
    out, ok = _run(tiny_root(family))
    assert not ok and out["checks"]["max_logit_gap"]["value"] > TINY_LIMIT


def control_root(tiny_root, family):
    """A size a test can hold (d 256, vocab 4096, 2 layers), at which
    float8 parts from fp32 by more than the rounding the limit allows."""
    return tiny_root(family, d_model=256, vocab_size=4096,
                     **({"d_ff": 512} if family == "dense" else {}))


@pytest.mark.parametrize("family", ["dense", "ssm"])
def test_the_float8_control_fails_the_limit(tiny_root, family):
    """The control, in the program's place, comes out not correct, while
    the program's own tokens of the same run keep the limit."""
    out, ok = _run(control_root(tiny_root, family), control=True)
    assert not ok, out["checks"]
    assert out["checks"]["max_logit_gap"]["value"] > TINY_LIMIT
    assert out["program_gap"] <= TINY_LIMIT


@pytest.mark.parametrize("control", [0, 1])
def test_the_result_line_under_the_control(tiny_root, control):
    """`run.py` end to end, its look for a card skipped: the result line
    reads `correct` true for the program and false with ``--control 1``,
    and its checks come last."""
    root = control_root(tiny_root, "dense")
    shutil.copytree(ROOT / "portbench" / "metrics",
                    root / "portbench" / "metrics")
    code = f"""
import sys
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]
import importlib.util, pathlib
sp = importlib.util.spec_from_file_location("r", {str(ROOT / 'portbench' / 'run.py')!r})
run = importlib.util.module_from_spec(sp); sp.loader.exec_module(run)
run.ROOT = pathlib.Path({str(root)!r})
run.card = lambda chips: ("cpu", "cpu")
sys.exit(run.main(["--workload", "tiny.mix", "--seed", "{2**31 + 5}",
                   "--seconds", "1", "--trace", "0", "--control",
                   "{control}"]))
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"] is (not control), line
    assert list(line)[-1] == "checks"
    gap = line["checks"]["max_logit_gap"]
    assert (gap["value"] > gap["limit"]) is bool(control)
    assert "gen_tok_s" in line["metrics"]


def test_a_run_loads_nothing_of_jax(tiny_root):
    root = tiny_root("dense")
    code = f"""
import sys, time
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]
import importlib.util
sp = importlib.util.spec_from_file_location("r", {str(ROOT / 'portbench' / 'run.py')!r})
run = importlib.util.module_from_spec(sp); sp.loader.exec_module(run)
from portbench.harness import cell
out = cell.run("tiny.mix", 3, 0.5, False, "cpu", t_start=time.perf_counter(),
               root=__import__("pathlib").Path({str(root)!r}))
print(run.forbidden(list(sys.modules)))
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "[]"


def test_run_refuses_without_a_card():
    """No CUDA card: exit code 2 and no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is here")
    res = subprocess.run(
        [sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
         "falcon-mamba-7b.long-prompt", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=ROOT)
    assert res.returncode == 2 and res.stdout.strip() == "", res.stderr
    with pytest.raises(json.JSONDecodeError):
        json.loads(res.stdout or "x")
