"""One CUDA graph for a model's whole one-token decode step.

Eager, a decode step is some 1,200-1,400 launches (norms, RoPE, the
projections, the cache writes, ``decode_attention``, the FFN or the Mamba
recurrence, layer by layer) at tens of microseconds of host time each,
so the card finishes each op before the host has issued the next.
`DecodeGraphs` captures the step once per cache and replays it: a call
then costs the host two input copies, one ``graph.replay()`` and a copy
of the logits.

The step can be captured as it stands: its shapes are static (the batch
is the caller's rows, the cache has ``max_len`` slots, inactive rows are
masked, not dropped), it writes the cache and state in place (a refill
splices a row in place too, so the leaves keep their addresses), and
nothing in it syncs with the host.

It engages where it can see that a capture is safe (`engages`): the
tokens on a CUDA device and no ``sharding_context`` (so no collective in
the step).  Everywhere else -- the CPU, a plan, any pilot mesh -- the step
runs eagerly, as it did before.

A graph belongs to the memory it reads and writes: its key (`graph_key`)
is the address, shape, stride and dtype of every cache and param leaf,
with the shapes and dtypes of the tokens and positions.  A miss applies
the step once, eagerly (its result is the call's, and it warms cuBLAS),
then captures it from static copies of the inputs: a capture records
kernels without running them, so the cache and the SSM state advance
exactly once a call -- Mamba's conv and state updates, unlike a KV write,
are not idempotent.  A hit copies the call's tokens and positions into
the static inputs, replays, and returns a copy of the static logits, so
that nothing a caller keeps is written over by the next replay.  At most
`MAX_GRAPHS` graphs are kept (the least recently used goes first), and an
entry holds no reference to its cache: it is dropped, with its memory
pool, when the cache's first leaf is freed.  A cache whose leaves are new
objects each call (views made afresh) therefore recaptures every call.

Captures are counted in `captures`, replays in `replays`; a replay also
adds to the kernel wrappers' launch counters the launches its capture
recorded (``kernels.recorded_launches``), so the counters count what ran.
"""
from __future__ import annotations

import threading
import weakref
from collections import OrderedDict
from typing import Callable, Dict

import torch

from repro_torch import kernels
from repro_torch.models.common import tree_leaves
from repro_torch.parallel.sharding import current_context

# graphs kept a decode callable: one for each replica on one card
MAX_GRAPHS = 4
# one capture at a time in the process: torch.cuda.graph captures on one
# shared side stream
_CAPTURE_LOCK = threading.Lock()


def engages(tokens) -> bool:
    """A decode call with these tokens may run as a CUDA graph: on a CUDA
    device, with no sharding context."""
    return tokens.device.type == "cuda" and current_context() is None


def graph_key(params, cache, tokens, positions) -> tuple:
    """What a captured step reads and writes: every cache and param
    leaf's (address, shape, stride, dtype), and the inputs' shapes and
    dtypes."""
    return (tuple((t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)
                  for t in tree_leaves(cache) + tree_leaves(params)),
            tuple(tokens.shape), tokens.dtype,
            tuple(positions.shape), positions.dtype)


class _Graph:
    """A captured step: the graph, its static inputs and logits, the
    launches it records, and the finalizer that drops it with its
    cache."""

    def __init__(self, graph, tokens, positions, logits, launches: Dict):
        self.graph = graph
        self.tokens = tokens
        self.positions = positions
        self.logits = logits
        self.launches = launches
        self.finalizer = None

    def replay(self, tokens, positions):
        self.tokens.copy_(tokens)
        self.positions.copy_(positions)
        self.graph.replay()
        kernels.add_launches(self.launches)
        return self.logits.clone()


def _forget(ref, key) -> None:
    graphs = ref()
    if graphs is not None:
        graphs._graphs.pop(key, None)


class DecodeGraphs:
    """The decode callable of one model: `step(params, cache, tokens,
    positions) -> (logits, cache)` run eagerly, or as a CUDA graph where
    it `engages` (module doc)."""

    def __init__(self, step: Callable):
        self.step = step
        self.captures = 0
        self.replays = 0
        self._graphs: "OrderedDict[tuple, _Graph]" = OrderedDict()
        self._lock = threading.Lock()

    def __call__(self, params, cache, tokens, positions):
        if not engages(tokens):
            return self.step(params, cache, tokens, positions)
        key = graph_key(params, cache, tokens, positions)
        entry = self._graphs.get(key)
        if entry is None:
            out = self.step(params, cache, tokens, positions)
            self._add(key, cache,
                      self._capture(params, cache, tokens, positions))
            return out
        logits = entry.replay(tokens, positions)
        with self._lock:
            self.replays += 1
            if key in self._graphs:
                self._graphs.move_to_end(key)
        return logits, cache

    def _capture(self, params, cache, tokens, positions) -> _Graph:
        """Record the step on static copies of the inputs (nothing runs)."""
        st_tokens, st_positions = tokens.clone(), positions.clone()
        graph = torch.cuda.CUDAGraph()
        with _CAPTURE_LOCK, kernels.recorded_launches() as launches:
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                logits, _ = self.step(params, cache, st_tokens, st_positions)
        return _Graph(graph, st_tokens, st_positions, logits, launches)

    def _add(self, key, cache, entry: _Graph) -> None:
        entry.finalizer = weakref.finalize(tree_leaves(cache)[0], _forget,
                                           weakref.ref(self), key)
        with self._lock:
            self.captures += 1
            self._graphs[key] = entry
            while len(self._graphs) > MAX_GRAPHS:
                _, old = self._graphs.popitem(last=False)
                old.finalizer.detach()
