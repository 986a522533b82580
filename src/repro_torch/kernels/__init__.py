"""Hand-written Hopper kernels of the port, one directory each: the
kernel's source and its wrapper, an ``ops.py`` dispatcher and a
``ref.py`` plain PyTorch version of the same function.

The kernels are forward-only (the JAX package has no backward kernel
either): a launch fills its output through a raw pointer, which leaves no
autograd history.  So each ``*_op`` refuses, on every route, a tensor
argument that requires grad while grad mode is on (`refuse_autograd`):
on the CPU the plain version would be differentiable, and a caller that
trained through it would lose its gradients silently on the card.

Each wrapper counts its launches in module counters (``LAUNCHES`` and the
like) through `count_launch`.  A CUDA graph's capture records kernels
without running them, so inside `recorded_launches` a launch is noted
for the caller instead, and `add_launches` counts the noted launches
each time the graph replays them (``models/decode_graphs.py``)."""
import contextlib
import threading
from typing import Dict, Iterator

import torch

_recording = threading.local()


def count_launch(module, *counters: str) -> None:
    """One launch of `module`'s kernel: add one to each of its
    `counters` under the module's ``_count_lock``, or, inside
    `recorded_launches` on this thread, note it there."""
    tally = getattr(_recording, "tally", None)
    if tally is None:
        add_launches({module: {name: 1 for name in counters}})
        return
    per = tally.setdefault(module, {})
    for name in counters:
        per[name] = per.get(name, 0) + 1


def add_launches(tally: Dict) -> None:
    """Add `tally` ({module: {counter: launches}}) to the modules'
    counters."""
    for module, per in tally.items():
        with module._count_lock:
            for name, n in per.items():
                setattr(module, name, getattr(module, name) + n)


@contextlib.contextmanager
def recorded_launches() -> Iterator[Dict]:
    """Note this thread's launches in the yielded tally instead of
    counting them (a graph capture: nothing runs)."""
    prev = getattr(_recording, "tally", None)
    _recording.tally = tally = {}
    try:
        yield tally
    finally:
        _recording.tally = prev


def refuse_autograd(op: str, *tensors) -> None:
    """Raise if grad mode is on and any of `tensors` requires grad."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{op} is forward-only: its kernel records no autograd history, "
            f"so a gradient would be lost on the card; call it under "
            f"torch.no_grad() or torch.inference_mode(), or train through "
            f"the model's training route (train=True)")


def is_abstract(t: torch.Tensor) -> bool:
    """A tensor with a shape and no data: fake (``FakeTensorMode``) or on
    the meta device.  The dispatchers plan a call on one (an empty output
    of the kernel's shape, its cost charged to ``roofline.op_cost``)."""
    from torch._subclasses.fake_tensor import is_fake
    return t.device.type == "meta" or is_fake(t)
