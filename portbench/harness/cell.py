"""One run of a cell: the program under the cell's traffic, its window,
its metrics and its output check.

Set-up draws the weights on the device from the seed
(``harness/weights.py``), hands them to ``ServingEngine(params=...)`` on
a one-pilot ``PilotSession``, deploys, and starts the closed loop: each
of the mix's clients submits its next request the moment its last one
completes.  Warm-up ends on a count of completions (the mix's
``warmup_completions``); the window then runs for `seconds` on the host's
clock, with the engine's counters read at both ends, the card's peak
memory counted from its opening (the padded first wave is set-up's, not
what serving holds) and set-up's objects frozen out of the garbage
collector's scans until it closes.  The model the engine runs is the
program's, wrapped (`Wrapper`): on a traced run the wrapper records each prefill's and
decode's shapes over the window and drives the profiler slice; otherwise
it only passes the calls on.  Once the window has closed and the peak
memory is read, the engine and the session are closed and their memory
freed, and the output check runs (``harness/check.py``).
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from portbench.harness import check as check_mod
from portbench.harness import spec, trace, traffic, weights

# the pilot's managed memory (GiB), as the program's own serving smoke run
PILOT_MEMORY_GB = 8
# the traced slice: profiler sessions, decode calls (passes) in each,
# sessions that may fail, seconds a session may take
SLICE_SESSIONS, SLICE_CALLS, SLICE_RETRIES, SLICE_TIMEOUT_S = 4, 3, 2, 60
WARMUP_TIMEOUT_S = 240


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def model_config(cfg: dict):
    """The program's ModelConfig from a configuration file: every key that
    names one of its fields, a nested block as its sub-config."""
    from repro_torch.configs import base
    names = {f.name for f in dataclasses.fields(base.ModelConfig)}
    kw = {k: v for k, v in cfg.items() if k in names}
    for key, cls in (("ssm", base.SSMConfig), ("moe", base.MoEConfig),
                     ("mla", base.MLAConfig)):
        if isinstance(kw.get(key), dict):
            kw[key] = cls(**kw[key])
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in kw.items()}
    return base.ModelConfig(**kw)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k], prefix + (k,))]
    return [(prefix, tree)]


def check_layout(specs, params) -> None:
    """The drawn weights have the program's paths, shapes and dtypes."""
    want = {p: (tuple(s.shape), s.dtype) for p, s in _flat(specs)}
    got = {p: (tuple(t.shape), t.dtype) for p, t in _flat(params)}
    if want != got:
        diff = sorted(set(want.items()) ^ set(got.items()))
        raise ValueError(f"the reference layout and the program's params "
                         f"differ: {diff[:6]}")


def load_module(path: Path, name: str):
    sp = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod


class Wrapper:
    """The benchmark's wrapper of the program's model: passes the calls
    on; on a traced run it also records each call of the window (a
    prefill's rows and length, a decode's positions and which rows moved
    on, so which were served) and, while a slice is on, puts a marker
    kernel at each call's two ends (``harness/trace.py``).  A slice
    starts and ends at a decode call, so it holds whole passes; at both
    ends the engine's loop holds until the main thread has started or
    stopped the profiler (`hold`), so that no kernel is launched while
    the profiler starts or stops."""

    HOLD_TIMEOUT_S = 120

    def __init__(self, model, traced: bool, faults=None):
        self.inner = model
        self.traced = traced
        self.faults = faults or {}
        self.recording = False
        self.calls: List[tuple] = []
        self.last_pos: Optional[np.ndarray] = None
        self.slicing = False
        self.phase = "idle"           # idle | armed | on
        self.left = 0
        self.marks: List[str] = []    # the slice's markers, in order
        self.held = threading.Event()     # the loop waits at a slice's end
        self.go = threading.Event()       # ... until this is set

    def model(self):
        return dataclasses.replace(self.inner, prefill=self.prefill,
                                   decode=self.decode)

    def arm(self, calls: int) -> None:
        """Trace the passes of the next `calls` decode calls; the loop
        holds at the first of them and at the last."""
        self.marks, self.left = [], calls
        self.held.clear()
        self.phase = "armed"

    def disarm(self) -> None:
        """End any slice and let the loop go on."""
        self.phase, self.slicing = "idle", False
        self.go.set()

    def release(self) -> None:
        self.held.clear()
        self.go.set()

    def hold(self) -> None:
        """On the loop's thread: signal `held`, wait for `release`."""
        self.go.clear()
        self.held.set()
        if not self.go.wait(self.HOLD_TIMEOUT_S):
            self.phase, self.slicing = "idle", False

    def _mark(self, name: str) -> None:
        trace.mark()
        self.marks.append(name)

    def _slice(self) -> None:
        if self.phase == "armed":
            self.hold()                 # the profiler starts meanwhile
            if self.phase != "armed":
                return
            self._mark("slice.start")
            self.slicing, self.phase = True, "on"
        elif self.phase == "on":
            self.left -= 1
            if self.left <= 0:
                self._mark("slice.end")
                self.slicing, self.phase = False, "idle"
                self.hold()             # the profiler stops meanwhile

    def _call(self, label: str, fn, *args):
        if not self.slicing:
            return fn(*args)
        self._mark(f"{label}.start")
        out = fn(*args)
        self._mark(f"{label}.end")
        return out

    def prefill(self, params, batch, max_len):
        if self.recording or self.slicing:
            rows, s = batch["tokens"].shape[:2]
            self.calls.append(("prefill", time.perf_counter(),
                               self.recording, self.slicing, int(rows),
                               int(s)))
        return self._call("prefill", self.inner.prefill, params, batch,
                          max_len)

    def decode(self, params, cache, tokens, positions):
        if self.traced:
            self._slice()
            pos = positions.cpu().numpy().astype(np.int64)
            last = self.last_pos
            moved = (pos > 0) if last is None or last.shape != pos.shape \
                else pos != last
            self.last_pos = pos
            if self.recording or self.slicing:
                self.calls.append(("decode", time.perf_counter(),
                                   self.recording, self.slicing, pos,
                                   moved))
        fault = self.faults.get("decode")
        fn = self.inner.decode if fault is None else (
            lambda *a: fault(self.inner.decode, *a))
        return self._call("decode", fn, params, cache, tokens, positions)


class ClosedLoop:
    """The mix's clients on one thread: every `POLL_S` it hands each
    client whose request has finished its next one, so a client submits
    the moment (to `POLL_S`) its last request completes; every finished
    request is kept with its clock.  One thread, mostly asleep, so that
    the load takes little of the host from the engine's loop."""

    POLL_S = 0.02

    def __init__(self, engine, requests: traffic.Requests, clients: int):
        self.engine = engine
        self.requests = requests
        self.clients = clients
        self.finished: List = []
        self.cond = threading.Condition()
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True,
                                       name="portbench-clients")
        self.error: Optional[BaseException] = None

    def start(self) -> None:
        self.thread.start()

    def _submit(self):
        return self.engine.submit(*self.requests.next())

    def _run(self) -> None:
        try:
            live = [self._submit() for _ in range(self.clients)]
            while True:
                stopping = self.stop.wait(self.POLL_S)
                for i, req in enumerate(live):
                    if req.done:
                        with self.cond:
                            self.finished.append(req)
                            self.cond.notify_all()
                        if not stopping:
                            live[i] = self._submit()
                if stopping:        # the last sweep keeps what finished
                    return
        except Exception as e:  # noqa: BLE001 - reported by the main thread
            if not self.stop.is_set():
                self.error = e
                with self.cond:
                    self.cond.notify_all()

    def wait(self, count: int, timeout: float, alive: Callable[[], bool]):
        """Block until `count` requests have finished."""
        t0 = time.monotonic()
        deadline, shown = t0 + timeout, t0
        with self.cond:
            while len(self.finished) < count:
                if time.monotonic() - shown > 30:
                    shown = time.monotonic()
                    log(f"warm-up: {len(self.finished)} of {count} after "
                        f"{shown - t0:.0f} s; {self.engine.stats()['refills']}"
                        f" refills")
                if self.error is not None:
                    raise RuntimeError("the clients failed") from self.error
                if not alive():
                    raise RuntimeError("the engine's loop has stopped")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{len(self.finished)} of {count} "
                                       f"warm-up requests after {timeout} s")
                self.cond.wait(0.5)

    def close(self) -> None:
        self.stop.set()
        self.thread.join(timeout=30)
        if self.thread.is_alive():
            raise RuntimeError("the client thread did not stop")


def _dump(engine) -> None:
    """On a failure: the engine's stats, its loop's error, every
    thread's stack."""
    import faulthandler
    try:
        st = engine.stats()
        log(f"engine stats at the failure: "
            f"{ {k: v for k, v in st.items() if k != 'replicas'} }; "
            f"replicas {st['replicas']}; loop error {engine._crash!r}")
    except Exception as e:     # noqa: BLE001 - best effort
        log(f"no engine stats: {e!r}")
    faulthandler.dump_traceback(file=sys.stderr, all_threads=True)


def _alive(engine) -> bool:
    """The engine's loop has not failed (a failed loop is counted in
    ``replica_deaths`` even where the engine adopts its pilot again)."""
    st = engine.stats()
    return (bool(st["replicas"]) and not st["replica_deaths"]
            and not any(r["dead"] for r in st["replicas"].values()))


COUNTERS = ("tokens_served", "decode_passes", "decode_steps", "refills",
            "waves")


def run(workload: str, seed: int, seconds: float, traced: bool, device,
        *, t_start: float, root: Path = spec.ROOT, control: bool = False,
        faults=None) -> dict:
    """One run of `workload`; returns the result line's fields and the
    checks (see ``portbench/run.py``)."""
    bench = spec.load(root)
    cell = spec.workload(bench, workload)
    entry = spec.config_entry(bench, cell["config"])
    cfg = spec.read_json(Path(root) / entry["file"])
    mix = traffic.load(cell["traffic"], Path(root) / "portbench")
    ref = importlib.import_module(f"portbench.reference.{cfg['reference']}")
    device = torch.device(device)
    on_card = device.type == "cuda"

    from repro_torch.core import PilotSession
    from repro_torch.models.model import build_model
    from repro_torch.serving import ServingEngine

    mcfg = model_config(cfg)
    layout = ref.layout(cfg)
    params = weights.make(layout, seed, device)
    model = build_model(mcfg)
    check_layout(model.specs, params)
    wrap = Wrapper(model, traced and on_card, faults)
    requests = traffic.Requests(mix, cfg["vocab_size"], seed)
    out: Dict = {}
    log(f"weights drawn, model built: {time.perf_counter() - t_start:.3f} s "
        f"after start")
    sliced = None
    with PilotSession(device=device) as session:
        session.add_pilot(memory_gb=PILOT_MEMORY_GB)
        engine = ServingEngine(session, wrap.model(), params=params,
                               name=workload, batch_size=mix["rows"],
                               max_len=mix["max_len"],
                               page_tokens=mix["page_tokens"], seed=seed)
        del params
        t0 = time.perf_counter()
        with engine:
            engine.deploy()
            engine.wait_ready(timeout=600)
            deploy_s = time.perf_counter() - t0
            log(f"deployed in {deploy_s:.3f} s; warm-up to "
                f"{mix['warmup_completions']} completions")
            loop = ClosedLoop(engine, requests, mix["clients"])
            loop.start()
            try:
                loop.wait(mix["warmup_completions"], WARMUP_TIMEOUT_S,
                          lambda: _alive(engine))
                if on_card:     # the window's own peak, not the first wave's
                    torch.cuda.reset_peak_memory_stats(device)
                # set-up's objects leave the collector's view, so that a
                # collection in the window scans only what serving makes
                gc.collect()
                gc.freeze()
                before = engine.stats()
                w0 = time.perf_counter()
                wrap.recording = True
                while time.perf_counter() < w0 + seconds:
                    time.sleep(min(0.5, max(0.0, w0 + seconds
                                            - time.perf_counter())))
                    if loop.error is not None or not _alive(engine):
                        raise RuntimeError("the engine stopped in the "
                                           "window") from loop.error
                w1 = time.perf_counter()
                after = engine.stats()
                wrap.recording = False
                peak = (torch.cuda.max_memory_allocated(device) if on_card
                        else 0)
                # the traced slice: the passes right after the window,
                # under the same load; the profiler first starts here, so
                # that the window runs without it
                if wrap.traced:
                    sliced = trace.take_all(wrap, SLICE_SESSIONS,
                                            SLICE_CALLS, SLICE_RETRIES,
                                            SLICE_TIMEOUT_S)
            except BaseException:
                _dump(engine)
                raise
            finally:
                gc.unfreeze()
                loop.close()
    finished = list(loop.finished)
    del engine, loop, session, wrap.inner, model
    gc.collect()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        log(f"after teardown {torch.cuda.memory_allocated(device)} bytes "
            f"allocated; peak {peak}")
    window = [r for r in finished if w0 <= r.t_done <= w1]
    ok = [r for r in window if r.error is None]
    run_ns = SimpleNamespace(
        config=cfg, mix=mix, cell=cell, setup_s=w0 - t_start,
        deploy_s=deploy_s, window_s=w1 - w0,
        delta={k: after[k] - before[k] for k in COUNTERS},
        latencies=[r.latency_s for r in ok],
        calls=[c for c in wrap.calls if c[2]],
        slice=sliced)
    out["run"] = run_ns
    out["attempted"] = len(window)
    out["failed"] = len(window) - len(ok)
    out["peak"] = peak
    log(f"window: {run_ns.window_s:.3f} s, {len(ok)} requests completed "
        f"({out['failed']} failed), counters {run_ns.delta}; set-up "
        f"{run_ns.setup_s:.3f} s (deploy {deploy_s:.3f} s)")
    out["checks"], out["program_gap"] = check_mod.run(
        ref, cfg, layout, mix, seed, device, ok, out["failed"],
        limits_path=Path(root) / "portbench" / "limits" / f"{workload}.json",
        control=control)
    return out
