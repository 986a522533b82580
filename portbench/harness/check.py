"""The output check: the served tokens held to the plain fp32 reference.

Once the window has closed and the program's memory is freed, a sample of
the requests completed in the window is drawn from the seed: the longest
of them (prompt and output), then others in an order drawn from the seed
until the sample holds the mix's ``check_tokens`` served tokens.  The
weights are drawn again from the seed, and the family's reference runs
once over each prompt with its served tokens (all but the last), giving
the fp32 logits at every position where a token was served.  A served
token's gap is the reference's best logit there less the reference's
logit of the served token: 0 where the program chose as the reference
would, small where the two lie within rounding of each other.  The number
compared is the widest gap of the sample, against the cell's limit in
``limits/<workload>.json``.

With `control` the reference runs a second time with every product in
float8 (``reference/ops.py``) and is put in the program's place: at each
position compared, the token that float8 puts first is judged instead of
the served one, by the same gap and against the same limit, so that
`passed` has to come out false.  The program's own widest gap is given
beside it.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path
from typing import List

import numpy as np
import torch

from portbench.harness import weights
from portbench.reference import ops


def sample(done: List, seed: int, tokens: int) -> List:
    """The requests to compare: the longest, then the seed's order."""
    if not done:
        return []
    done = sorted(done, key=lambda r: r.rid)
    longest = max(done, key=lambda r: (len(r.prompt) + len(r.tokens), -r.rid))
    rest = [r for r in done if r is not longest]
    order = np.random.default_rng([seed, 1]).permutation(len(rest))
    out, n = [longest], len(longest.tokens)
    for i in order:
        if n >= tokens:
            break
        out.append(rest[i])
        n += len(rest[i].tokens)
    return out


def _inputs(reqs, device):
    """Each request's prompt with its served tokens but the last, the
    positions whose logits chose the served tokens, and those tokens."""
    seqs, wanted, served = [], [], []
    for r in reqs:
        toks = np.asarray(r.tokens, dtype=np.int64)
        seq = np.concatenate([np.asarray(r.prompt, np.int64), toks[:-1]])
        p = len(r.prompt)
        seqs.append(torch.from_numpy(seq).to(device))
        wanted.append(torch.arange(p - 1, p - 1 + len(toks), device=device))
        served.append(torch.from_numpy(toks).to(device))
    return seqs, wanted, served


def gap(exact, chosen) -> np.ndarray:
    """The reference's best logit less its logit of each chosen token."""
    return (exact.max(-1).values - exact.gather(-1, chosen[:, None])[:, 0]
            ).double().cpu().numpy()


def run(ref, cfg, layout, mix, seed, device, done, failed: int, *,
        limits_path: Path, control: bool = False):
    """-> (checks: {name: {"value", "limit"}}, the program's widest gap
    where `control` put float8's in its place, else None); `passed` holds
    them.  A value of None is a number that could not be read (no request
    to compare), a limit of None a cell with no limits file: either
    fails."""
    limits = (json.loads(Path(limits_path).read_text())
              if Path(limits_path).exists() else {})
    picked = sample(done, seed, mix["check_tokens"])
    wrong_len = sum(len(r.tokens) != r.max_new_tokens
                    or not all(0 <= t < cfg["vocab_size"] for t in r.tokens)
                    for r in picked)
    if device.type == "cuda":
        ops.fp32_only()
    params = weights.make(layout, seed, device)
    widest = control_gap = None
    if picked and not wrong_len:
        seqs, wanted, served = _inputs(picked, device)
        with torch.no_grad():
            exact = ref.logits(cfg, params, seqs, wanted, ops.exact)
            widest = max(float(gap(e, t).max())
                         for e, t in zip(exact, served))
            if control:
                low = ref.logits(cfg, params, seqs, wanted, ops.fp8)
                control_gap = max(float(gap(e, lo.argmax(-1)).max())
                                  for e, lo in zip(exact, low))
        print(f"compared {sum(len(t) for t in served)} served tokens of "
              f"{len(picked)} requests (prompts "
              f"{[len(r.prompt) for r in picked]}); widest gap {widest!r}"
              + (f"; float8 control's, in its place, {control_gap!r}"
                 if control else ""), file=sys.stderr)
    del params
    checks = {
        "max_logit_gap": {"value": control_gap if control else widest,
                          "limit": limits.get("max_logit_gap", {}).get(
                              "limit")},
        "tokens_compared": {"value": int(sum(len(r.tokens) for r in picked)),
                            "limit": int(mix["check_tokens"])},
        "wrong_length": {"value": int(wrong_len), "limit": 0},
        "failed_requests": {"value": int(failed), "limit": 0},
    }
    return checks, (widest if control else None)


def passed(checks: dict) -> bool:
    """Every check within its limit: at most it, but ``tokens_compared``,
    at least it."""
    ok = True
    for name, c in checks.items():
        v, lim = c["value"], c["limit"]
        if v is None or lim is None:      # nothing compared, or no limit
            return False
        ok = ok and bool(v >= lim if name == "tokens_compared" else v <= lim)
    return ok
