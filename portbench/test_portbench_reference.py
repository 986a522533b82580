"""The plain references against the program's models at a tiny size on
the CPU: the same weights (drawn by the benchmark), a prefill and decode
steps through the program's cache, the reference's full forward pass."""

import pytest
import torch

from portbench.conftest import TINY
from portbench.harness import cell, weights
from portbench.reference import dense, ops, ssm
from repro_torch.models.model import build_model

REFS = {"dense": dense, "ssm": ssm}


def _program_logits(cfg, params, tokens, steps):
    """Prefill tokens[:, :-steps], then decode the rest one at a time:
    the program's logits at every position from the prompt's last."""
    model = build_model(cell.model_config(cfg))
    b, t = tokens.shape
    p = t - steps
    logits, cache = model.prefill(params, {"tokens": tokens[:, :p]}, t + 1)
    out = [logits]
    for i in range(steps):
        pos = torch.full((b,), p + i, dtype=torch.int32)
        logits, cache = model.decode(params, cache, tokens[:, p + i:p + i + 1],
                                     pos)
        out.append(logits)
    return torch.stack(out, 1)                     # (b, steps + 1, vocab)


@pytest.mark.parametrize("family,extra", [
    ("dense", {}), ("dense", {"sliding_window": 12}),
    ("dense", {"ffn_act": "swiglu"}), ("ssm", {})])
def test_reference_matches_the_program(family, extra):
    cfg = dict(TINY[family], name="t", dtype="float32", **extra)
    layout = REFS[family].layout(cfg)
    params = weights.make(layout, 20260418, "cpu")
    cell.check_layout(build_model(cell.model_config(cfg)).specs, params)
    tokens = torch.randint(0, cfg["vocab_size"], (3, 20),
                           generator=torch.Generator().manual_seed(1))
    got = _program_logits(cfg, params, tokens, 5)
    seqs = [tokens[i] for i in range(3)]
    wanted = [torch.arange(14, 20) for _ in range(3)]
    with torch.no_grad():
        want = REFS[family].logits(cfg, params, seqs, wanted)
    for i in range(3):
        assert torch.allclose(got[i, :6], want[i], atol=2e-4, rtol=1e-4), \
            (got[i, :6] - want[i]).abs().max()
    with torch.no_grad():
        low = REFS[family].logits(cfg, params, seqs, wanted, ops.fp8)
    assert max(float((a - b).abs().max()) for a, b in zip(low, want)) > 1e-3


def test_weights_repeat_by_seed_and_follow_their_draws():
    cfg = dict(TINY["ssm"], name="t", dtype="bfloat16")
    a = weights.make(ssm.layout(cfg), 5, "cpu")
    b = weights.make(ssm.layout(cfg), 5, "cpu")
    c = weights.make(ssm.layout(cfg), 6, "cpu")
    flat = lambda t: [x for _, x in cell._flat(t)]           # noqa: E731
    assert all(torch.equal(x, y) for x, y in zip(flat(a), flat(b)))
    assert not torch.equal(a["embed"], c["embed"])
    s = a["layers"]["ssm"]
    assert torch.equal(s["a_log"][0, 0], torch.log(torch.arange(1.0, 5.0)))
    dt = torch.nn.functional.softplus(s["dt_bias"])
    assert float(dt.min()) >= 1e-4 - 1e-7 and float(dt.max()) <= 0.1 + 1e-6
    std = float(a["layers"]["ssm"]["w_in"].float().std())
    assert abs(std - 64 ** -0.5) < 0.1 * 64 ** -0.5
