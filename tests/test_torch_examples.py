"""The six ported examples (examples/torch/*.py) on the CPU, at the sizes
their flags allow, each held to numpy or to the JAX package:

- quickstart: the compute unit's trace and the map_reduce sum of squares
  are numpy's;
- kmeans_pilot: on each tier (file, host, device) the SSE history and the
  final centroids are ``repro.core.kmeans``'s (JAX) on the same
  ``make_blobs`` points, rtol 1e-4;
- multipilot_scaling: its SSE history is the reference session's, at
  least one read goes to a sibling, and the read after invalidation is
  coherent;
- elastic_failover: at least one respawn, replication restored, the data
  intact, and the step loop's final state exact through its recoveries;
- serve_lm and train_lm: every request served its tokens, and the
  printed losses are finite and fall.

Without CUDA each example's default device raises.
"""
import importlib.util
import math
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

EXAMPLES = Path(__file__).resolve().parents[1] / "examples" / "torch"
NAMES = ("quickstart", "kmeans_pilot", "multipilot_scaling",
         "elastic_failover", "serve_lm", "train_lm")
CPU = ["--device", "cpu"]


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"torch_example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_is_numpys():
    got = _example("quickstart").main(CPU)
    want = np.eye(4, dtype=np.float32) @ np.arange(16.0).reshape(4, 4)
    assert got["trace"] == float(want.trace()) == 30.0
    data = np.random.default_rng(0).normal(size=(8192, 16)).astype(
        np.float32)
    np.testing.assert_allclose(got["sum_sq"], float(
        (data.astype(np.float64) ** 2).sum()), rtol=1e-5)
    assert got["residency"] == {"device": 4}


def test_kmeans_pilot_is_the_jax_kmeans():
    from repro.core import DataUnit, kmeans, make_backend, make_blobs
    got = _example("kmeans_pilot").main(
        CPU + ["--scenario", "iii", "--iters", "2", "--dim", "2"])
    assert (got["n"], got["k"]) == (10_000, 5_000)
    pts, _ = make_blobs(10_000, 256, d=2)
    du = DataUnit.from_array("pts", pts, 4, {"host": make_backend("host")},
                             tier="host")
    ref = kmeans(du, k=5_000, iters=2)
    assert set(got["tiers"]) == {"file", "host", "device"}
    for tier, res in got["tiers"].items():
        np.testing.assert_allclose(res["sse_history"], ref.sse_history,
                                   rtol=1e-4, err_msg=tier)
        np.testing.assert_allclose(res["centroids"], np.asarray(
            ref.centroids), rtol=1e-4, atol=1e-6, err_msg=tier)


def test_multipilot_scaling_is_the_reference_session():
    from repro.core import InterconnectModel, PilotSession, make_blobs
    got = _example("multipilot_scaling").main(CPU)
    pts, _ = make_blobs(8_000, 8, d=16, seed=0)
    with PilotSession(interconnect=InterconnectModel()) as s:
        pilots = s.add_pilots(2, memory_gb=0.05)
        du = s.data("points", pts, parts=8)
        du.replicate_to_pilot(pilots[0], parts=range(0, 4))
        du.replicate_to_pilot(pilots[1], parts=range(4, 8))
        ref = s.kmeans(du, k=8, iters=3)
    np.testing.assert_allclose(got["sse_history"], ref.sse_history,
                               rtol=1e-4)
    assert got["sibling_reads"] >= 1
    assert got["coherent"] and got["holders_after_write"] == []
    assert got["pilots"] == 2


def test_elastic_failover_recovers_exactly():
    got = _example("elastic_failover").main(CPU)
    act1, act2 = got["act1"], got["act2"]
    assert act1["respawns"] >= 1 and act1["under"] == 0 and act1["intact"]
    assert all(math.isfinite(x) for x in act1["sse_history"])
    assert act2["w"] == 20.0 and act2["step"] == 20
    assert act2["recoveries"]


def test_serve_lm_serves_every_request():
    st = _example("serve_lm").main(CPU)
    assert st["completed"] == st["requests"] == 16
    assert [len(t) for t in st["tokens"]] == [32] * 16
    assert st["tokens_served"] == 16 * 32


def test_train_lm_losses_fall(capsys):
    final = _example("train_lm").main(CPU + ["--steps", "41", "--seq", "64"])
    out = capsys.readouterr().out
    losses = [float(x) for x in re.findall(r"\[train\] step +\d+ loss=(\S+)",
                                           out)]
    assert len(losses) >= 3, out
    assert all(math.isfinite(x) for x in losses + [final])
    assert losses[-1] < losses[0] and final < losses[0], losses


@pytest.mark.parametrize("name", NAMES)
def test_the_default_device_is_the_card(name):
    """No --device: the examples run on the card, and raise without one
    (no quiet fall back to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("this box has a card: the default device resolves")
    with pytest.raises(RuntimeError, match="CUDA"):
        _example(name).main([])
