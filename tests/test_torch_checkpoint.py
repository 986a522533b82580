"""repro_torch.checkpoint: the cases of tests/test_checkpoint.py (bf16
round trip, async overlap, GC, a chosen step) but elastic restore, which
waits for the port's mesh; and checkpoints crossing between the two
packages: a TrainState with bf16 params and int8 AdamW state saved by
`repro`'s CheckpointManager restores in the port bit for bit, and the
reverse, with the same leaf names.  Exact equality throughout.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.checkpoint import \
    CheckpointManager as RefCheckpointManager  # noqa: E402
from repro.optim.adamw import OptState as RefOptState  # noqa: E402
from repro.optim import quant as ref_quant  # noqa: E402
from repro.train.steps import TrainState as RefTrainState  # noqa: E402
from repro_torch.checkpoint.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.optim.adamw import OptState  # noqa: E402
from repro_torch.optim.quant import (LogQTensor, QTensor,  # noqa: E402
                                     quantize, quantize_log)
from repro_torch.train.steps import TrainState  # noqa: E402


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    params = {"w": torch.randn(8, 16, generator=g).to(torch.bfloat16),
              "scan": torch.randn(4, 8, 8, generator=g).to(torch.bfloat16)}
    opt = OptState(m={k: v.float() for k, v in params.items()},
                   v={k: v.float() for k, v in params.items()},
                   count=torch.tensor(7, dtype=torch.int32))
    return TrainState(params, opt)


def _bits(t):
    """A leaf's bytes as numpy (a bf16 tensor or array by its uint16s)."""
    if isinstance(t, torch.Tensor):
        t = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        return t.numpy().view(np.uint16) if t.dtype == torch.int16 \
            else t.numpy()
    a = np.asarray(t)
    return a.view(np.uint16) if a.dtype == jnp.bfloat16 else a


def _assert_same(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(_bits(x), _bits(y))


def test_roundtrip_bf16(tmp_path):
    ckpt = CheckpointManager(tmp_path)
    state = _state()
    ckpt.save(10, state)
    restored, step = ckpt.restore(state)
    assert step == 10
    assert isinstance(restored, TrainState)
    assert isinstance(restored.opt_state, OptState)
    _assert_same(restored, state)
    info = ckpt.write_log[-1]
    assert info["step"] == 10 and info["bytes"] == sum(
        t.numel() * t.element_size() for t in tree_leaves(state))


def test_async_save_then_restore(tmp_path):
    ckpt = CheckpointManager(tmp_path)
    state = _state()
    ckpt.save(5, state, blocking=False)
    restored, step = ckpt.restore(state)  # restore waits for the writer
    assert step == 5
    assert int(restored.opt_state.count) == 7


def test_async_snapshot_is_taken_before_save_returns(tmp_path):
    """The step after an async save may update the state in place (AdamW
    does): the checkpoint holds the state as it was at save()."""
    ckpt = CheckpointManager(tmp_path)
    state = _state()
    before = [t.clone() for t in tree_leaves(state)]
    ckpt.save(5, state, blocking=False)
    for t in tree_leaves(state):
        t.add_(1)
    restored, _ = ckpt.restore(state)
    for got, want in zip(tree_leaves(restored), before):
        np.testing.assert_array_equal(_bits(got), _bits(want))


def test_gc_keeps_latest(tmp_path):
    ckpt = CheckpointManager(tmp_path, keep=2)
    state = _state()
    for s in (1, 2, 3, 4):
        ckpt.save(s, state)
    assert sorted(ckpt.list_steps()) == [3, 4]
    assert ckpt.latest_step() == 4


def test_restore_specific_step(tmp_path):
    ckpt = CheckpointManager(tmp_path, keep=5)
    s1, s2 = _state(1), _state(2)
    ckpt.save(1, s1)
    ckpt.save(2, s2)
    r1, _ = ckpt.restore(s1, step=1)
    np.testing.assert_array_equal(_bits(r1.params["w"]), _bits(s1.params["w"]))
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").restore(s1)


# -- across the two packages ---------------------------------------------------
def _int8_states(seed=0):
    """The same TrainState in both packages: bf16 params, int8 moments
    quantized from the same numpy values, count 7."""
    rng = np.random.default_rng(seed)
    vals = {"embed": rng.normal(size=(40, 16)).astype(np.float32),
            "layers": {"w": rng.normal(size=(2, 16, 24)).astype(np.float32),
                       "norm": rng.normal(size=(2, 16)).astype(np.float32)}}
    mom = jax.tree.map(lambda a: 0.1 * a, vals)
    sec = jax.tree.map(lambda a: np.exp(a).astype(np.float32), vals)
    ref = RefTrainState(
        jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), vals),
        RefOptState(m=jax.tree.map(lambda a: ref_quant.quantize(
                        jnp.asarray(a)), mom),
                    v=jax.tree.map(lambda a: ref_quant.quantize_log(
                        jnp.asarray(a)), sec),
                    count=jnp.int32(7)))
    t = lambda f, tree: {k: (t(f, v) if isinstance(v, dict) else f(v))
                         for k, v in tree.items()}
    port = TrainState(
        t(lambda a: torch.from_numpy(a).to(torch.bfloat16), vals),
        OptState(m=t(lambda a: quantize(torch.from_numpy(a)), mom),
                 v=t(lambda a: quantize_log(torch.from_numpy(a)), sec),
                 count=torch.tensor(7, dtype=torch.int32)))
    return ref, port


def _manifest(root, step):
    return json.loads((root / f"step_{step:08d}" / "manifest.json")
                      .read_text())["leaves"]


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    ref, port = _int8_states()
    RefCheckpointManager(tmp_path).save(3, ref)
    restored, step = CheckpointManager(tmp_path).restore(port)
    assert step == 3
    assert isinstance(restored.opt_state.m["embed"], QTensor)
    assert isinstance(restored.opt_state.v["layers"]["w"], LogQTensor)
    assert restored.opt_state.m["layers"]["w"].shape == (2, 16, 24)
    ref_leaves = jax.tree.leaves(ref)
    got = tree_leaves(restored)
    assert len(got) == len(ref_leaves) == len(_manifest(tmp_path, 3))
    for g, r in zip(got, ref_leaves):
        np.testing.assert_array_equal(_bits(g), _bits(r))
    # the port quantizes the same values to the same int8 codes
    np.testing.assert_array_equal(_bits(restored.opt_state.m["embed"].data),
                                  _bits(port.opt_state.m["embed"].data))


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    ref, port = _int8_states(seed=1)
    (tmp_path / "a").mkdir()
    CheckpointManager(tmp_path / "a").save(4, port)
    RefCheckpointManager(tmp_path / "b").save(4, ref)
    assert _manifest(tmp_path / "a", 4).keys() == \
        _manifest(tmp_path / "b", 4).keys()
    assert "opt_state/m/layers/w/0" in _manifest(tmp_path / "a", 4)
    assert _manifest(tmp_path / "a", 4)["params/embed"]["dtype"] == "bfloat16"
    restored, step = RefCheckpointManager(tmp_path / "a").restore(ref)
    assert step == 4
    for r, p in zip(jax.tree.leaves(restored), tree_leaves(port)):
        assert np.asarray(r).dtype.name == (
            "bfloat16" if p.dtype == torch.bfloat16
            else str(p.numpy().dtype))
        np.testing.assert_array_equal(_bits(r), _bits(p))
