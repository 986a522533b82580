"""ServingEngine: continuous-batching LM serving ON the pilot substrate.

The port of ``repro/serving/engine.py``.  What differs from the JAX
package: the refill splice and the decode step update the batched cache
in place (no jit, no donation); sampling draws from a ``torch.Generator``
on the pilot's device; the param leaves are flattened in sorted-key order
(the order ``jax.tree_util`` walks a dict in) and a bf16 leaf is stored in
its shard as its uint16 bit pattern, with the dtypes kept beside the tree
structure; every tensor of a replica's loop lives on its pilot's
``devices[0]``, named explicitly (the resident loop's thread does not set
a current CUDA device).  The mesh/sharding branch of the runtime is gone.

The paper's whole argument is that retained resources (compute AND
memory) are the right home for data-intensive work.  The old
``launch/serve.py`` driver ran *beside* the pilot system: it held params
and KV state in loop locals, routed nothing through the scheduler, and
lost every in-flight request when a pilot died.  This module is the join:

  * **model shards are tiered Pilot-Data partitions** — the flattened
    param leaves become one DataUnit (``<name>.shards``) registered with
    ``persist=True`` (durable checkpoint home) and a replication target,
    replicated *pinned* into every serving pilot's managed tiers.  Each
    pilot reconstructs its params from its own replica through the
    zero-copy read path (``taskengine.read_partition`` → mmap/aliasing
    views) and retains them in the pilot's ``jit_cached`` executable
    cache — the paper's retain-and-reuse applied to weights;
  * **KV-cache pages are durable partitions** — each request's
    recoverable decode state (prompt + generated-so-far) is an
    appended partition of ``<name>.kv``, rewritten at page granularity
    (``page_tokens``) and written through to the durable tier, so the
    sequence needed to rebuild a KV cache survives the pilot that held
    the device-tier cache;
  * **requests route replica-aware** — dispatch goes through the
    session's ``SchedulingPolicy``: each request is scored as a CU whose
    ``input_data`` is the shards DU, so pilots holding shard replicas
    win, quarantined pilots are excluded fail-closed, and placements
    land in the scheduler's history/stats like any other work;
  * **decode loops are long-lived tasks** — each replica's continuous-
    batching loop runs on a resident task (``TaskEngine.submit_resident``)
    pinned to its pilot, so ``current_pilot()`` resolves inside the loop
    and shard reads hit that pilot's tiers;
  * **pilot loss mid-stream recovers from the durable tier** — under a
    supervising session a killed pilot is quarantined/respawned;
    this engine's reaper re-reads each in-flight request's KV pages from
    the home/checkpoint tier, re-prefills the recovered sequence on a
    surviving replica, and decoding continues for exactly the remaining
    tokens.  Greedy decoding makes the replayed tail deterministic;
    either way every request completes with its exact token count.

The continuous-batching loop here also fixes the two serve.py bugs:
finished rows ARE refilled (a pending prompt is dequeued, prefilled as a
batch-of-1 and spliced into the freed row of the batched cache), and
retired/padded rows are masked out of both sampling and the throughput
accounting (``tokens_served`` counts active rows only).
"""
from __future__ import annotations

import threading
import time
from collections import deque
from types import SimpleNamespace
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.carry import tensor_from_numpy, tensor_to_numpy
from repro_torch.core.device import to_device
from repro_torch.core.pilot import ComputeUnitDescription, State
from repro_torch.core.taskengine import read_partition
from repro_torch.models.common import tree_leaves


# ---------------------------------------------------------------------------
# pure helpers
# ---------------------------------------------------------------------------
def _batch_axis(dst_shape, src_shape) -> int:
    """The axis where a batched cache leaf and a batch-of-1 prefill leaf
    disagree — i.e. the batch axis, found structurally so every cache
    family works (``(L,B,S,...)`` dict stacks batch on axis 1, the
    parallel_ssm tuple layout on axis 0) without a per-model table."""
    for ax, (d, s) in enumerate(zip(dst_shape, src_shape)):
        if d != s:
            return ax
    return 0    # shapes equal: batch size 1 replacing row 0


def splice_row(cache, row_cache, row: int):
    """Continuous-batching refill: write a batch-of-1 prefill cache into
    row `row` of the batched cache (every leaf, at its own batch axis), in
    place.  This is the piece the old serve.py loop was missing — it reset
    ``positions`` but never installed a new prompt's KV state.  Leaves of
    equal shape (batch size 1) are copied whole: a narrow on axis 0 of a
    ``(L,B,...)`` leaf would write one layer, not one row."""
    def _one(dst, src):
        src = src.to(dst.dtype)
        if tuple(dst.shape) == tuple(src.shape):
            dst.copy_(src)
        else:
            ax = _batch_axis(dst.shape, src.shape)
            dst.narrow(ax, row, 1).copy_(src)

    for dst, src in zip(tree_leaves(cache), tree_leaves(row_cache)):
        _one(dst, src)
    return cache


def sample_tokens(logits, active, generator: torch.Generator,
                  temperature: float):
    """Next-token sampling with inactive rows masked out: retired and
    padded rows still occupy the batch (shapes stay static), but their
    sampled token is forced to 0 so they never leak into outputs — and
    callers count only ``active`` rows as served.  Greedy (temperature 0)
    is argmax; otherwise draws come from `generator` (on logits' device)."""
    if temperature > 0:
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        tok = torch.multinomial(probs, 1, generator=generator)[:, 0]
    else:
        tok = torch.argmax(logits, dim=-1)
    return torch.where(active, tok, 0).to(torch.int32)


def flatten_params(tree, prefix: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """(path, leaf) pairs of a nested-dict param tree, sorted-key order."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in flatten_params(tree[k], prefix + (k,))]
    return [(prefix, tree)]


def unflatten_params(paths: Sequence[Tuple], leaves: Sequence[Any]):
    """The nested-dict tree of `flatten_params`, rebuilt from its leaves."""
    if len(paths) == 1 and paths[0] == ():
        return leaves[0]
    out: Dict[str, Any] = {}
    for path, leaf in zip(paths, leaves):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


# ---------------------------------------------------------------------------
class ServeRequest:
    """One in-flight generation request and its result future.

    ``rid`` is the request's partition index in the engine's KV-page
    DataUnit; ``ctx`` is the sequence to prefill when (re)entering a
    batch row — the prompt initially, the recovered prompt+generated
    pages after a failover; ``prior`` is the recovered generated prefix,
    so ``prior + fresh tokens == max_new_tokens`` exactly."""

    __slots__ = ("rid", "prompt", "max_new_tokens", "ctx", "prior",
                 "tokens", "error", "pilot_id", "recoveries",
                 "t_submit", "t_done", "_done")

    def __init__(self, rid: int, prompt: np.ndarray, max_new_tokens: int):
        self.rid = rid
        self.prompt = prompt
        self.max_new_tokens = int(max_new_tokens)
        self.ctx = prompt
        self.prior: List[int] = []
        self.tokens: Optional[List[int]] = None
        self.error: Optional[BaseException] = None
        self.pilot_id: Optional[str] = None
        self.recoveries = 0
        self.t_submit = time.perf_counter()
        self.t_done: Optional[float] = None
        self._done = threading.Event()

    @property
    def done(self) -> bool:
        return self._done.is_set()

    @property
    def latency_s(self) -> Optional[float]:
        return None if self.t_done is None else self.t_done - self.t_submit

    def result(self, timeout: Optional[float] = None) -> List[int]:
        if not self._done.wait(timeout):
            raise TimeoutError(f"request {self.rid} not done after "
                               f"{timeout}s")
        if self.error is not None:
            raise self.error
        return list(self.tokens or [])

    def _finish(self, tokens: List[int]) -> None:
        self.tokens = tokens
        self.t_done = time.perf_counter()
        self._done.set()

    def _fail(self, exc: BaseException) -> None:
        self.error = exc
        self.t_done = time.perf_counter()
        self._done.set()

    def __repr__(self) -> str:
        state = ("done" if self.done and self.error is None
                 else "error" if self.done else "pending")
        return f"ServeRequest(rid={self.rid}, n={self.max_new_tokens}, " \
               f"{state})"


class _Replica:
    """One serving pilot's routed-request queue + resident-loop handle."""

    def __init__(self, pilot):
        self.pilot = pilot
        self.queue: deque = deque()
        self.cond = threading.Condition()
        self.stop = threading.Event()
        self.task = None                      # resident taskengine.Task
        self.dead = False
        self.active: Dict[int, ServeRequest] = {}   # row -> request

    def push(self, req: ServeRequest) -> None:
        with self.cond:
            self.queue.append(req)
            self.cond.notify_all()

    def pop(self, timeout: float) -> Optional[ServeRequest]:
        with self.cond:
            if not self.queue and timeout > 0:
                self.cond.wait(timeout)
            return self.queue.popleft() if self.queue else None

    def wake(self) -> None:
        with self.cond:
            self.cond.notify_all()

    def drain(self) -> List[ServeRequest]:
        """Every request this replica still owes: queued + in rows.  Only
        called after the resident loop has exited (the reaper joins the
        task first), so the row map is quiescent."""
        with self.cond:
            out = list(self.queue)
            self.queue.clear()
        out.extend(self.active.values())
        self.active = {}
        return out


class _Runtime:
    """Per-pilot retained serving state (lives in pilot._jit_cache)."""

    def __init__(self, params, prefill, decode, device: torch.device):
        self.params = params
        self.prefill = prefill
        self.decode = decode
        self.device = device


# ---------------------------------------------------------------------------
class ServingEngine:
    """Continuous-batching LM serving on a PilotSession (module doc).

    Parameters
    ----------
    session: the PilotSession to serve on — its pilots (provisioned with
        ``memory_gb`` so they carry TierManagers) become serving
        replicas.  Pass ``supervise=True`` sessions for mid-stream
        pilot-loss recovery.
    model: a built model exposing ``prefill(params, batch, max_len)`` and
        ``decode(params, cache, tokens, positions)`` plus ``cfg`` (the
        contract of repro_torch.models.model.Model; the tests drive the
        engine with a stub model through the same surface).
    params: the param tree (nested dicts of tensors) to shard (default:
        ``model.init`` from a generator seeded `seed`, on the session's
        device).
    batch_size: decode rows per replica (equal-batch comparisons against
        the isolated stack use the same number).
    page_tokens: KV-page flush granularity — a request's durable state is
        rewritten every `page_tokens` generated tokens (and at finish).
    replication: shard replication target (default ``min(2, n_pilots)``).
    """

    def __init__(self, session, model, *, params=None, name: str = "serve",
                 batch_size: int = 4, max_len: int = 256,
                 temperature: float = 0.0, page_tokens: int = 16,
                 replication: Optional[int] = None, seed: int = 0):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.session = session
        self.model = model
        self.cfg = model.cfg
        self.name = name
        self.batch_size = int(batch_size)
        self.max_len = int(max_len)
        self.temperature = float(temperature)
        self.page_tokens = max(1, int(page_tokens))
        self._replication = replication
        self._seed = seed
        self._params = params
        self.shards = None                    # DataUnit: model shard leaves
        self.kv = None                        # DataUnit: per-request pages
        self._paths: List[Tuple] = []         # param tree structure
        self._bf16: List[bool] = []           # leaves stored as bf16 bits
        self._n_shards = 0
        self._replicas: Dict[str, _Replica] = {}
        self._unrouted: deque = deque()
        self._lock = threading.Lock()
        self._done_cond = threading.Condition(self._lock)
        self._requests: List[ServeRequest] = []
        self._completed = 0
        self._deployed = False
        self._closed = False
        self._reaper_stop = threading.Event()
        self._reaper: Optional[threading.Thread] = None
        self.counters = {"tokens_served": 0, "decode_steps": 0,
                         "refills": 0, "waves": 0, "recovered_requests": 0,
                         "replica_deaths": 0, "drained_replicas": 0}

    # -- deployment ------------------------------------------------------
    def deploy(self, reaper_interval_s: float = 0.05) -> "ServingEngine":
        """Shard the params into Pilot-Data, replicate them to every
        pilot, start a resident decode loop per replica and the failover
        reaper.  Idempotent."""
        if self._deployed:
            return self
        pilots = [p for p in self.session.pilots
                  if p.state is State.RUNNING]
        if not pilots:
            raise RuntimeError("ServingEngine.deploy: the session has no "
                               "running pilots")
        if self._params is None:
            dev = self.session.device
            gen = torch.Generator(device=dev).manual_seed(self._seed)
            self._params = self.model.init(gen, device=dev)
        flat = flatten_params(self._params)
        self._paths = [path for path, _ in flat]
        self._bf16 = [t.dtype == torch.bfloat16 for _, t in flat]
        np_leaves = [tensor_to_numpy(t, bf16_bits=True) for _, t in flat]
        self._n_shards = len(np_leaves)
        pds = self.session.data_service
        durable = pds.checkpoint_store is not None
        repl = (self._replication if self._replication is not None
                else min(2, len(pilots)))
        self.shards = self.session.data_parts(
            f"{self.name}.shards", np_leaves, tier="host",
            persist=durable, replication=repl)
        self.kv = self.session.data_parts(
            f"{self.name}.kv", [], tier="host", persist=False)
        self._durable = durable
        self._deployed = True
        for p in pilots:
            self._attach_replica(p)
        self._reaper = threading.Thread(
            target=self._reaper_loop, args=(reaper_interval_s,),
            daemon=True, name=f"{self.name}-reaper")
        self._reaper.start()
        # the session's autoscaler reads load() from here and asks for
        # replica handoff before scaling a serving pilot in
        if self not in self.session.serving_engines:
            self.session.serving_engines.append(self)
        return self

    def _attach_replica(self, pilot) -> None:
        """Join one pilot to the serving fleet: shard replicas pinned
        into its tiers (best effort — a capacity-refused leaf is pulled
        through lazily on first read) and a resident decode loop spawned
        on the pilot's worker pool."""
        pds = self.session.data_service
        if pds.knows(pilot.id):
            pds.replicate_to_pilot(self.shards, pilot.id, tier="host",
                                   pin=True)
        rep = _Replica(pilot)
        rep.task = self.session.manager.engine.submit_resident(
            self._serve_loop, rep, pilot=pilot,
            name=f"{self.name}-decode")
        with self._lock:
            self._replicas[pilot.id] = rep

    # -- request intake / routing ---------------------------------------
    def submit(self, prompt, max_new_tokens: int) -> ServeRequest:
        """Accept one request: its prompt becomes a durable KV-page
        partition, then it is routed replica-aware to a serving pilot."""
        if not self._deployed:
            raise RuntimeError("ServingEngine.submit before deploy()")
        if self._closed:
            raise RuntimeError("ServingEngine is closed")
        prompt = np.asarray(prompt, dtype=np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        rid = self.kv.append_partition(prompt)
        if self._durable:
            self.kv.persist(parts=[rid])
        req = ServeRequest(rid, prompt, max_new_tokens)
        with self._lock:
            self._requests.append(req)
        self._route(req)
        return req

    def _eligible_replicas(self) -> List[_Replica]:
        with self._lock:
            reps = [r for r in self._replicas.values()
                    if not r.dead and r.pilot.state is State.RUNNING]
        policy = self.session.manager.policy
        ok = {p.id for p in policy.eligible([r.pilot for r in reps])}
        return [r for r in reps if r.pilot.id in ok]

    def _route(self, req: ServeRequest) -> None:
        """Replica-aware dispatch: score the request as a CU reading the
        shards DU, so the policy credits pilots holding shard replicas
        (and the quarantine filter fails closed — with no eligible
        replica the request parks in the unrouted queue until the
        supervisor respawns one)."""
        reps = self._eligible_replicas()
        if not reps:
            with self._lock:
                self._unrouted.append(req)
            return
        desc = ComputeUnitDescription(
            fn=_noop, input_data=(self.shards,),
            name=f"{self.name}:req{req.rid}")
        pilot, score = self.session.manager.policy.select(
            [r.pilot for r in reps], desc)
        self.session.manager.record_batch(
            pilot, (SimpleNamespace(desc=desc),), score)
        req.pilot_id = pilot.id
        with self._lock:
            rep = self._replicas.get(pilot.id)
        if rep is None or rep.dead:
            with self._lock:
                self._unrouted.append(req)
            return
        rep.push(req)

    # -- per-pilot retained runtime --------------------------------------
    def _pilot_runtime(self, pilot) -> _Runtime:
        """The pilot's retained serving state: params reconstructed on the
        pilot's ``devices[0]`` from its own shard replicas (zero-copy reads
        through the pilot's tiers, then one copy to the device; a respawned
        pilot pulls through from siblings or the checkpoint home) and the
        prefill/decode callables, all living in the pilot's executable
        cache so a second loop on the same pilot pays nothing."""
        def build():
            dev = pilot.devices[0]
            leaves = [tensor_from_numpy(read_partition(self.shards, i), dev,
                                        bfloat16=self._bf16[i])
                      for i in range(self._n_shards)]
            params = unflatten_params(self._paths, leaves)
            model, max_len = self.model, self.max_len

            def pf(params, batch):
                return model.prefill(params, batch, max_len)

            return _Runtime(params, pf, model.decode, dev)
        return pilot.jit_cached((self.name, "runtime"), build)

    def _prefill_batch(self, ctx_rows: np.ndarray, device) -> dict:
        return {"tokens": to_device(ctx_rows, device)}

    # -- the continuous-batching loop ------------------------------------
    def _serve_loop(self, rep: _Replica) -> int:
        """One replica's decode loop (a long-lived resident task pinned
        to its pilot).  Returns the number of requests it completed; on
        pilot loss it returns early, leaving its queue + rows for the
        reaper's failover.  It runs under ``torch.inference_mode()``: the
        cache it splices and decodes in place is inference state."""
        with torch.inference_mode():
            return self._decode_rows(rep)

    def _decode_rows(self, rep: _Replica) -> int:
        pilot = rep.pilot
        rt = self._pilot_runtime(pilot)
        dev = rt.device
        B = self.batch_size
        rows: List[Optional[ServeRequest]] = [None] * B
        row_gen = np.zeros(B, np.int64)       # tokens generated in-row
        row_out: List[List[int]] = [[] for _ in range(B)]
        positions = np.zeros(B, np.int32)
        cache = None
        logits = None
        gen = torch.Generator(device=dev).manual_seed(self._seed + 1)
        served = 0

        def fill_row(r: int, req: ServeRequest) -> None:
            nonlocal cache, logits
            with self._lock:
                self.counters["refills"] += 1
            row_logits, row_cache = rt.prefill(
                rt.params, self._prefill_batch(req.ctx[None, :], dev))
            cache = splice_row(cache, row_cache, r)
            logits[r] = row_logits[0]
            rows[r] = req
            rep.active[r] = req
            row_gen[r] = 0
            row_out[r] = []
            positions[r] = len(req.ctx) - 1

        def fill_wave(reqs: List[ServeRequest]) -> None:
            """First fill only (cache is None): batched prefill of every
            same-length context, free rows padded with copies of the
            first — padded rows start INACTIVE (rows[r] is None), so the
            masking keeps them out of sampling and accounting."""
            nonlocal cache, logits
            with self._lock:
                self.counters["waves"] += 1
            ctxs = [q.ctx for q in reqs]
            pad = ctxs[0]
            while len(ctxs) < B:
                ctxs.append(pad)
            logits, cache = rt.prefill(
                rt.params, self._prefill_batch(np.stack(ctxs), dev))
            for r, req in enumerate(reqs):
                rows[r] = req
                rep.active[r] = req
                row_gen[r] = 0
                row_out[r] = []
                positions[r] = len(req.ctx) - 1

        while True:
            if rep.stop.is_set():
                return served
            if pilot.state is not State.RUNNING:
                # node loss: abandon the rows — the reaper recovers every
                # owed request from the durable KV pages
                rep.dead = True
                with self._lock:
                    self.counters["replica_deaths"] += 1
                return served
            # -- refill freed rows (the missing piece of the old loop) --
            free = [r for r in range(B) if rows[r] is None]
            idle = all(q is None for q in rows)
            for r in free:
                req = rep.pop(timeout=0.02 if idle and r == free[0] else 0)
                if req is None:
                    break
                if cache is None:
                    wave = [req]
                    want = len(req.ctx)
                    while len(wave) < B:
                        nxt = rep.pop(timeout=0)
                        if nxt is None:
                            break
                        if len(nxt.ctx) != want:
                            rep.push(nxt)   # ragged ctx: spliced next pass
                            break
                        wave.append(nxt)
                    fill_wave(wave)
                    break
                fill_row(r, req)
                idle = False
            active = np.array([q is not None for q in rows])
            if not active.any():
                continue
            # -- sample (inactive rows masked), account, retire ----------
            tok = sample_tokens(logits, to_device(active, dev), gen,
                                self.temperature)
            tok_np = tok.cpu().numpy()
            n_active = int(active.sum())
            with self._lock:
                self.counters["tokens_served"] += n_active
            for r in range(B):
                req = rows[r]
                if req is None:
                    continue
                row_out[r].append(int(tok_np[r]))
                row_gen[r] += 1
                remaining = req.max_new_tokens - len(req.prior)
                finished = row_gen[r] >= remaining
                if finished or row_gen[r] % self.page_tokens == 0:
                    self._flush_pages(req, row_out[r])
                if finished:
                    self._complete(req, list(req.prior) + row_out[r])
                    rows[r] = None
                    rep.active.pop(r, None)
                    served += 1
            still = np.array([q is not None for q in rows])
            if still.any():
                positions[still] += 1
                logits, cache = rt.decode(rt.params, cache, tok[:, None],
                                          to_device(positions, dev))
                with self._lock:
                    self.counters["decode_steps"] += 1
            if hasattr(pilot, "beat"):
                pilot.beat()    # a busy decode loop vouches for liveness

    def _complete(self, req: ServeRequest, tokens: List[int]) -> None:
        """Finish a request exactly once: a replica finishing a request
        in the same instant the reaper recovers it (or two replicas
        racing after a failover re-run) must not double-count."""
        with self._lock:
            if req.done:
                return
            req._finish(tokens)
            self._completed += 1
            self._done_cond.notify_all()

    def _flush_pages(self, req: ServeRequest, out: List[int]) -> None:
        """Rewrite the request's KV-page partition (prompt + everything
        generated) in the home tier and write it through to the durable
        checkpoint home — the state a failover re-prefills from."""
        full = np.concatenate([
            req.prompt,
            np.asarray(req.prior + out, dtype=np.int32)])
        self.kv.update_partition(req.rid, full)
        if self._durable:
            self.kv.persist(parts=[req.rid])

    # -- failover --------------------------------------------------------
    def _reaper_loop(self, interval_s: float) -> None:
        while not self._reaper_stop.wait(interval_s):
            try:
                self._reap_once()
            except Exception:   # noqa: BLE001 - reaping races teardown
                pass

    def _reap_once(self) -> None:
        """One failover sweep: recover requests owed by dead replicas,
        adopt pilots the supervisor respawned, and re-route anything
        parked while the fleet was fully quarantined."""
        with self._lock:
            reps = list(self._replicas.items())
        for pid, rep in reps:
            crashed = rep.task is not None and rep.task.done
            if (not rep.dead and not crashed
                    and rep.pilot.state is State.RUNNING):
                continue
            if not rep.dead:    # loop didn't self-detect (e.g. it crashed)
                with self._lock:
                    self.counters["replica_deaths"] += 1
            self._retire_replica(pid, rep)
        # adopt respawned and scaled-out pilots (fresh ids; respawn and
        # scale-out share the provision path) — but never a draining one:
        # a drained-but-still-RUNNING victim must not be instantly
        # re-adopted while the autoscaler evacuates it
        pds = self.session.data_service
        draining = getattr(self.session.manager.policy, "draining",
                           frozenset())
        with self._lock:
            known = set(self._replicas)
        for p in self.session.pilots:
            if (p.state is State.RUNNING and p.id not in known
                    and p.id not in draining and pds.knows(p.id)):
                self._attach_replica(p)
        with self._lock:
            parked = list(self._unrouted)
            self._unrouted.clear()
        for req in parked:
            self._route(req)

    def _retire_replica(self, pid: str, rep: _Replica) -> None:
        """Take one replica out of the fleet and re-home every request it
        owes — the single retirement path shared by reaped-dead replicas
        and autoscaler-drained live ones."""
        rep.dead = True
        rep.stop.set()
        rep.wake()
        # join the resident loop before draining so the row map is
        # quiescent — no request can be half-owned during recovery
        if rep.task is not None:
            try:
                rep.task.result(timeout=5.0)
            except Exception:   # noqa: BLE001 - crash IS the signal
                pass
        with self._lock:
            self._replicas.pop(pid, None)
        for req in rep.drain():
            if not req.done:
                self._recover(req)

    def drain_replica(self, pilot_id: str) -> int:
        """Hand off a still-healthy replica ahead of scale-in: stop its
        decode loop and recover its in-flight requests from durable KV
        pages exactly like a reaped dead replica's.  Returns the number
        of requests handed off; 0 when the pilot serves no replica."""
        with self._lock:
            rep = self._replicas.get(pilot_id)
        if rep is None:
            return 0
        owed = len(rep.queue) + len(rep.active)
        self._retire_replica(pilot_id, rep)
        with self._lock:
            self.counters["drained_replicas"] += 1
        return owed

    def load(self) -> dict:
        """The autoscaler's serving signal: routed-but-unfinished request
        count and the oldest such request's age."""
        now = time.perf_counter()
        oldest: Optional[float] = None
        queued = 0
        with self._lock:
            reps = list(self._replicas.values())
            unrouted = list(self._unrouted)
        waiting: List[ServeRequest] = list(unrouted)
        for rep in reps:
            with rep.cond:
                waiting.extend(rep.queue)
        for req in waiting:
            if req.done:
                continue
            queued += 1
            if oldest is None or req.t_submit < oldest:
                oldest = req.t_submit
        return {"queued": queued,
                "oldest_wait_s": 0.0 if oldest is None else now - oldest}

    def _recover(self, req: ServeRequest) -> None:
        """Rebuild a request from the durable tier: the KV-page partition
        (home placement, falling back to the checkpoint store through the
        normal fetch chain) holds prompt + generated-so-far as of the
        last page flush; the tail since then is re-decoded — identical
        under greedy decoding, and exactly counted either way."""
        try:
            pages = np.asarray(self.kv.partition(req.rid),
                               dtype=np.int32).reshape(-1)
        except (KeyError, FileNotFoundError):
            pages = req.prompt
        plen = len(req.prompt)
        req.prior = [int(t) for t in pages[plen:]]
        req.ctx = pages if len(pages) > plen else req.prompt
        if len(req.prior) >= req.max_new_tokens:
            # every token was already durable: complete without a re-run
            self._complete(req, list(req.prior[:req.max_new_tokens]))
            return
        req.recoveries += 1
        with self._lock:
            self.counters["recovered_requests"] += 1
        self._route(req)

    # -- waiting / teardown ----------------------------------------------
    def drain(self, timeout: Optional[float] = None) -> None:
        """Block until every submitted request has completed."""
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        with self._done_cond:
            while self._completed < len(self._requests):
                rem = (None if deadline is None
                       else deadline - time.monotonic())
                if rem is not None and rem <= 0:
                    raise TimeoutError(
                        f"{len(self._requests) - self._completed} requests "
                        f"still in flight after {timeout}s")
                self._done_cond.wait(rem if rem is None else min(rem, 0.1))

    def close(self, timeout: float = 10.0) -> None:
        """Stop the reaper and every resident decode loop (idempotent);
        the session (and the shard/KV DataUnits) stay open — they are the
        caller's."""
        if self._closed:
            return
        self._closed = True
        if self in self.session.serving_engines:
            self.session.serving_engines.remove(self)
        self._reaper_stop.set()
        if self._reaper is not None:
            self._reaper.join(timeout)
        with self._lock:
            reps = list(self._replicas.values())
        for rep in reps:
            rep.stop.set()
            rep.wake()
        for rep in reps:
            if rep.task is not None:
                try:
                    rep.task.result(timeout=timeout)
                except Exception:   # noqa: BLE001 - dead replica loops
                    pass

    def __enter__(self) -> "ServingEngine":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.close()
        return False

    # -- telemetry -------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            reqs = list(self._requests)
            completed = self._completed
            replicas = {pid: {"dead": rep.dead,
                              "queued": len(rep.queue),
                              "active_rows": len(rep.active)}
                        for pid, rep in self._replicas.items()}
            unrouted = len(self._unrouted)
        lats = sorted(r.latency_s for r in reqs
                      if r.latency_s is not None)
        out = dict(self.counters)
        out.update({
            "requests": len(reqs), "completed": completed,
            "unrouted": unrouted, "replicas": replicas,
            "p50_latency_s": _pct(lats, 0.50),
            "p99_latency_s": _pct(lats, 0.99),
        })
        return out

    def __repr__(self) -> str:
        return (f"ServingEngine({self.name!r}, replicas="
                f"{len(self._replicas)}, batch={self.batch_size}, "
                f"requests={len(self._requests)})")


def _pct(sorted_vals: Sequence[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
    return float(sorted_vals[i])


def _noop():
    return None
