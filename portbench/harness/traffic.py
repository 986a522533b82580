"""The one traffic generator: a mix is a file of parameters under
``portbench/traffic/``, and this module turns it and a seed into requests.

A mix draws its prompt and output lengths from fixed sets of `levels`
values: ``log_uniform`` spaces them evenly in log between `low` and `high`
(both ends included), ``uniform`` evenly.  Requests come in blocks; a
block pairs every prompt length once with every output length once, each
set shuffled by the seed.  So every seed sends the same sizes in another
order, any block's worth of consecutive requests holds every size, and
warm-up meets every shape the window will.  Prompt token ids are uniform
over the vocabulary, drawn from the seed.  The program receives only the
ids and the number of tokens to generate.
"""
from __future__ import annotations

import threading
from pathlib import Path
from typing import List, Tuple

import numpy as np

from portbench.harness.spec import PACKAGE, read_json

KEYS = {"loop", "clients", "rows", "max_len", "page_tokens", "prompt",
        "output", "warmup_completions", "check_tokens"}


def load(name: str, package: Path = PACKAGE) -> dict:
    mix = read_json(Path(package) / "traffic" / f"{name}.json")
    missing = KEYS - set(mix)
    if missing:
        raise ValueError(f"traffic {name}: missing {sorted(missing)}")
    if mix["loop"] != "closed":
        raise ValueError(f"traffic {name}: only a closed loop is generated, "
                         f"got {mix['loop']!r}")
    return mix


def levels(dist: dict) -> List[int]:
    """The set of lengths a distribution entry stands for."""
    k, lo, hi = dist["levels"], dist["low"], dist["high"]
    u = np.linspace(0.0, 1.0, k)
    if dist["dist"] == "log_uniform":
        vals = lo * (hi / lo) ** u
    elif dist["dist"] == "uniform":
        vals = lo + (hi - lo) * u
    else:
        raise ValueError(f"unknown distribution {dist['dist']!r}")
    return [int(round(v)) for v in vals]


class Requests:
    """The seed's endless sequence of requests, (prompt ids, new tokens);
    `next` is safe to call from many client threads."""

    def __init__(self, mix: dict, vocab_size: int, seed: int):
        self.prompts = levels(mix["prompt"])
        self.outputs = levels(mix["output"])
        if len(self.prompts) != len(self.outputs):
            raise ValueError("prompt and output levels must be as many")
        if max(self.prompts) + max(self.outputs) > mix["max_len"]:
            raise ValueError("a request would pass max_len")
        self.vocab_size = vocab_size
        self._rng = np.random.default_rng(seed)
        self._lock = threading.Lock()
        self._block: List[Tuple[int, int]] = []

    def _sizes(self) -> Tuple[int, int]:
        if not self._block:
            p = self._rng.permutation(len(self.prompts))
            o = self._rng.permutation(len(self.outputs))
            self._block = [(self.prompts[i], self.outputs[j])
                           for i, j in zip(p, o)][::-1]
        return self._block.pop()

    def next(self) -> Tuple[np.ndarray, int]:
        with self._lock:
            length, new = self._sizes()
            ids = self._rng.integers(0, self.vocab_size, size=length,
                                     dtype=np.int64).astype(np.int32)
        return ids, new
