"""repro_torch's elasticity layer against tests/test_autoscale.py.

Every case of test_autoscale.py runs on the port, on the CPU: the
autoscaler's decisions, the scale-in drain protocol, proactive
rebalancing, and the supervisor/serving interactions.  Where the outcome
is deterministic the port and the JAX package are held to the same
result on the same inputs:

  * ``LoadScalingPolicy.decide`` over one ScalingSignals sequence drawn
    from a seed gives the same (action, reason) list;
  * ``Rebalancer.plan`` over the same fleet and the same partition bytes
    gives the same migrations (partition, donor, receiver, bytes), priced
    the same to 1e-12, where no partition sits on two donors (there the
    port repairs the JAX package's double move onto one receiver);
  * a serving replica drained mid-stream on ``reduced(llama3_2_1b)`` in
    fp32 hands its requests off and they finish with the JAX engine's
    tokens, after the handoff too.

The timing-driven race (scale-in against a chaos kill) asserts the
invariants test_autoscale.py asserts, not equal traces.
"""
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

import repro.core as ref_core  # noqa: E402
import repro_torch.core as port_core  # noqa: E402
from repro_torch.core import (Autoscaler, InterconnectModel, Link,  # noqa: E402
                              LoadScalingPolicy, PilotSession, Rebalancer,
                              ScalingSignals)
from repro_torch.core.backends.base import register_backend  # noqa: E402
from repro_torch.core.backends.simulated import (  # noqa: E402
    ChaosEvent, ChaosPolicy, SimulatedClusterBackend)
from repro_torch.core.pilot import State  # noqa: E402
from repro_torch.models.common import ParamSpec  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402

CPU = {"device": "cpu"}


def _session(**kw):
    return PilotSession(**CPU, **kw)


# -- parity: the policy's decisions -----------------------------------------
def _signal_trace(pkg, n=60, seed=0):
    """ScalingSignals drawn from a seed: runs of hot, cold and in-band
    samples, so both hysteresis counters fire and reset."""
    rng = np.random.default_rng(seed)
    kinds = []
    while len(kinds) < n:       # runs of 1-5 samples of one kind
        kinds += [rng.choice(["hot", "cold", "mid", "serving", "squeezed"],
                             p=[0.3, 0.35, 0.15, 0.1, 0.1])] * int(
                                 rng.integers(1, 6))
    out = []
    for kind in kinds[:n]:
        workers = int(rng.integers(1, 9))
        load = {"hot": rng.uniform(1.5, 4.0), "cold": rng.uniform(0, 0.25),
                "mid": rng.uniform(0.3, 1.4), "serving": rng.uniform(0, 1),
                "squeezed": rng.uniform(0, 0.2)}[kind]
        out.append(pkg.ScalingSignals(
            n_pilots=int(rng.integers(1, 5)), workers=workers,
            queue_depth=int(load * workers), load=float(load),
            serving_queued=int(kind == "serving") * int(rng.integers(1, 9)),
            serving_wait_s=float(rng.uniform(0.4, 2.0)
                                 if kind == "serving" else 0.0),
            tier_pressure=float(rng.uniform(0.9, 1.0)
                                if kind == "squeezed" else
                                rng.uniform(0, 0.5))))
    return out


@pytest.mark.parametrize("knobs", [{}, {"hysteresis": 1},
                                   {"hysteresis": 3, "in_hysteresis": 2,
                                    "serving_wait_s": 1.0}])
def test_load_policy_decisions_equal_the_reference(knobs):
    got = []
    for pkg in (ref_core, port_core):
        pol = pkg.LoadScalingPolicy(**knobs)
        got.append([pol.decide(s) for s in _signal_trace(pkg)])
    assert got[1] == got[0]
    actions = {a for a, _ in got[1]}
    assert {"out", "in", "hold"} <= actions      # the trace exercises all


# -- parity: the rebalancer's plan ------------------------------------------
def _plan(pkg, rows, held, skew, max_moves):
    """3 pilots; partition i has rows[i] rows of 4 fp32; `held[j]` lists
    the partitions pilot j holds (host tier).  Returns the plan with
    pilots named by index."""
    ic = pkg.InterconnectModel(default=pkg.Link(gbps=10.0, latency_s=1e-4))
    kw = CPU if pkg is port_core else {}
    rng = np.random.default_rng(1)
    parts = [rng.normal(size=(r, 4)).astype(np.float32) for r in rows]
    with pkg.PilotSession(interconnect=ic, **kw) as s:
        pilots = s.add_pilots(3, memory_gb=0.05, host_memory_gb=0.2)
        du = s.data_parts("pts", parts)
        for p, idxs in zip(pilots, held):
            if idxs:
                s.data_service.replicate_to_pilot(du, p.id, parts=idxs,
                                                  tier="host")
        name = {p.id: j for j, p in enumerate(pilots)}
        plan = pkg.Rebalancer(s, skew=skew, max_moves=max_moves).plan()
        return [(m.du, m.part, name[m.src], name[m.dst], m.nbytes,
                 m.cost_s, m.status) for m in plan]


@pytest.mark.parametrize("case", [
    # one pilot holds everything, one a little, one nothing
    ((5, 9, 14, 20, 27, 35), ([0, 1, 2, 3, 4, 5], [5], []), 1.2, 4),
    # a grown fleet: two full pilots and an empty newcomer (no partition
    # on both donors: there the port's plan differs, see
    # test_rebalancer_never_moves_a_partition_twice_to_one_receiver)
    ((6, 11, 17, 23, 30, 38, 47, 57),
     ([0, 1, 2, 3, 4], [5, 6, 7], []), 1.1, 8)])
def test_rebalancer_plan_equals_the_reference(case):
    rows, held, skew, moves = case
    ref = _plan(ref_core, rows, held, skew, moves)
    ours = _plan(port_core, rows, held, skew, moves)
    assert ours, "the fleet is skewed: the plan must move something"
    assert [m[:5] + m[6:] for m in ours] == [m[:5] + m[6:] for m in ref]
    np.testing.assert_allclose([m[5] for m in ours], [m[5] for m in ref],
                               rtol=0, atol=1e-12)
    assert all(m[5] > 0 for m in ours)


# -- unit: policy hysteresis -------------------------------------------------
def test_load_policy_hysteresis_and_watermarks():
    pol = LoadScalingPolicy(scale_out_load=1.5, scale_in_load=0.25,
                            hysteresis=2, in_hysteresis=3)
    hot = ScalingSignals(n_pilots=1, queue_depth=6, workers=2, load=3.0)
    cold = ScalingSignals(n_pilots=2, queue_depth=0, workers=4, load=0.0)
    mid = ScalingSignals(n_pilots=2, queue_depth=2, workers=4, load=0.5)
    assert pol.decide(hot)[0] == "hold"
    action, reason = pol.decide(hot)
    assert action == "out" and "load 3.00" in reason
    assert pol.decide(mid)[0] == "hold"
    assert pol.decide(hot)[0] == "hold"       # streak restarted
    assert pol.decide(cold)[0] == "hold"
    assert pol.decide(cold)[0] == "hold"
    assert pol.decide(cold)[0] == "in"
    squeezed = ScalingSignals(n_pilots=1, workers=2, tier_pressure=0.99)
    pol2 = LoadScalingPolicy(hysteresis=1)
    action, reason = pol2.decide(squeezed)
    assert action == "out" and "tier pressure" in reason
    with pytest.raises(ValueError):
        LoadScalingPolicy(scale_out_load=1.0, scale_in_load=1.0)


# -- drain quiesces scheduling ----------------------------------------------
def test_draining_pilot_stops_receiving_work():
    with _session() as s:
        a, b = s.add_pilots(2, memory_gb=0.05)
        pol = s.manager.policy
        pol.drain(a.id)
        assert set(p.id for p in pol.eligible([a, b])) == {b.id}
        pol.quarantine(b.id)
        assert pol.eligible([a, b]) == []
        pol.undrain(a.id)
        pol.readmit(b.id)
        assert len(pol.eligible([a, b])) == 2
        pol.drain(a.id)
        batch = s.submit_tasks([(lambda x: x + 1, (i,)) for i in range(8)])
        assert batch.results(timeout=30) == list(range(1, 9))
        pol.undrain(a.id)


# -- scale-out ---------------------------------------------------------------
def test_scale_out_clones_fleet_and_records_decision():
    with _session() as s:
        s.add_pilots(1, memory_gb=0.05)
        a = Autoscaler(s, min_pilots=1, max_pilots=2)
        added = a.scale_out(reason="unit")
        assert len(added) == 1
        p = added[0]
        assert p.tier_manager is not None
        assert s.data_service.knows(p.id)
        assert p.desc.device == torch.device("cpu")   # the clone's device
        assert a.scale_out() == []
        actions = [d.action for d in a.decisions]
        assert actions == ["scale-out", "reject-out"]
        assert all("n_pilots" in d.signals for d in a.decisions)
        stats = a.stats()
        assert stats["counters"]["scale_outs"] == 1
        assert stats["counters"]["rejects"] == 1


def test_scale_out_respects_backend_capacity():
    register_backend(SimulatedClusterBackend(substrate="slurm",
                                             max_pilots=2))
    with _session() as s:
        s.add_pilot(backend="simulated", startup_seconds=0.01,
                    memory_gb=0.05)
        a = Autoscaler(s, min_pilots=1, max_pilots=8)
        assert len(a.scale_out(3)) == 1          # one provision left
        assert a.decisions[-1].action == "reject-out"
        assert "at capacity" in a.decisions[-1].reason
    register_backend(SimulatedClusterBackend())


def test_scale_in_respects_min_pilots_floor():
    with _session() as s:
        s.add_pilots(1, memory_gb=0.05)
        a = Autoscaler(s, min_pilots=1, max_pilots=4)
        assert a.scale_in() is None
        assert a.decisions[-1].action == "reject-in"
        assert len(s.pilots) == 1


def test_scale_in_never_picks_quarantined_pilot():
    with _session() as s:
        pilots = s.add_pilots(3, memory_gb=0.05)
        sick = pilots[0]
        s.manager.policy.quarantine(sick.id)
        a = Autoscaler(s, min_pilots=1, max_pilots=4)
        victim = a.scale_in()
        assert victim is not None and victim.id != sick.id
        assert sick.state is State.RUNNING


# -- property: drain-then-release never loses a partition --------------------
@settings(max_examples=6, deadline=None)
@given(parts=st.integers(min_value=2, max_value=5),
       replication=st.integers(min_value=0, max_value=2),
       persist=st.booleans(),
       load_victim=st.booleans())
def test_scale_in_never_loses_a_partition(parts, replication, persist,
                                          load_victim):
    """Every partition registered before scale-in is byte-identical
    readable after, from a surviving replica or the checkpoint tier."""
    rng = np.random.default_rng(parts * 10 + replication * 2 + persist)
    ref = rng.normal(size=(parts * 16, 3)).astype(np.float32)
    with tempfile.TemporaryDirectory() as ckpt:
        with _session(checkpoint_dir=ckpt) as s:
            s.add_pilots(3, memory_gb=0.05, host_memory_gb=0.2)
            du = s.data("pts", ref, parts=parts, replication=replication,
                        persist=persist)
            a = Autoscaler(s, min_pilots=1, max_pilots=4)
            victim = None
            if load_victim:
                victim = s.pilots[0]
                s.data_service.replicate_to_pilot(du, victim.id,
                                                  tier="host")
            released = a.scale_in(victim)
            assert released is not None
            d = a.decisions[-1]
            assert d.action == "scale-in" and d.pilot == released.id
            assert d.detail["evacuated"].get("failed", 0) == 0
            got = np.concatenate([np.asarray(du.partition(i))
                                  for i in range(parts)], axis=0)
            np.testing.assert_array_equal(got, ref)


# -- supervisor interaction: scale-in racing a chaos kill --------------------
def test_scale_in_racing_chaos_kill_picks_distinct_victim():
    register_backend(SimulatedClusterBackend(
        substrate="slurm",
        policy=ChaosPolicy(events=(ChaosEvent(at_s=0.15, action="kill"),),
                           target_index=0)))
    s = _session(supervise=True,
                 supervisor_kwargs={"interval_s": 0.02,
                                    "min_heartbeat_s": 0.05})
    try:
        doomed = s.add_pilot(backend="simulated", startup_seconds=0.01,
                             memory_gb=0.05)
        s.add_pilots(2, backend="simulated", startup_seconds=0.01,
                     memory_gb=0.05)
        a = Autoscaler(s, min_pilots=1, max_pilots=4)
        deadline = time.monotonic() + 5.0
        while doomed.state is State.RUNNING:
            assert time.monotonic() < deadline, "chaos kill never fired"
            time.sleep(0.01)
        released = None
        deadline = time.monotonic() + 8.0
        while released is None and time.monotonic() < deadline:
            released = a.scale_in(reason="race")
        assert released is not None, "scale-in never completed"
        assert released.id != doomed.id     # distinct victims
        deadline = time.monotonic() + 8.0
        while not s.supervisor.respawns:
            assert time.monotonic() < deadline, "kill never respawned"
            time.sleep(0.02)
        assert s.supervisor.respawns[0].old_pilot == doomed.id
        time.sleep(0.2)     # give the monitor a chance to misfire
        assert all(ev.old_pilot != released.id
                   for ev in s.supervisor.respawns)
        running = [p for p in s.pilots if p.state is State.RUNNING]
        assert len(running) == 2            # 3 - killed - released + respawn
    finally:
        s.close()


# -- serving: drained replicas hand off like reaped ones ---------------------
class _StubModel:
    """next = (last + 1) % vocab (the exact-token stub of the serving
    tests); `delay` slows each decode step so a drain lands mid-run."""

    def __init__(self, vocab=32, delay=0.0):
        self.cfg = SimpleNamespace(name="stub", vocab_size=vocab)
        self.vocab = vocab
        self.delay = delay

    # the engine draws the stub's one leaf, zeros, from its specs
    specs = {"w": ParamSpec((4,), (None,), "zeros", dtype=torch.float32)}

    def _step(self, last):
        logits = torch.nn.functional.one_hot(
            (last.long() + 1) % self.vocab, self.vocab).float() * 100.0
        return logits, {"last": last.to(torch.int32).reshape(-1, 1)}

    def prefill(self, params, batch, max_len):
        return self._step(batch["tokens"][:, -1])

    def decode(self, params, cache, tokens, positions):
        if self.delay:
            time.sleep(self.delay)
        return self._step(tokens[:, 0])


def _expected(prompt, gen, vocab=32):
    return [(int(prompt[-1]) + 1 + i) % vocab for i in range(gen)]


def _drain_mid_stream(s, eng, pilot, timeout=30.0):
    """The autoscaler's handoff order: wait until `pilot`'s replica holds
    rows, mark the pilot draining FIRST (so the reaper cannot re-adopt
    it), then hand its replica off.  Returns the requests handed off."""
    deadline = time.monotonic() + timeout
    while not eng._replicas[pilot.id].active:
        assert time.monotonic() < deadline, "the replica never held a row"
        time.sleep(0.002)
    s.manager.policy.drain(pilot.id)
    return eng.drain_replica(pilot.id)


def test_serving_drain_replica_hands_off_in_flight_requests():
    model = _StubModel(delay=0.02)      # slow decode: drain lands mid-run
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 32, size=5).astype(np.int32)
               for _ in range(4)]
    with tempfile.TemporaryDirectory() as ckpt:
        with _session(checkpoint_dir=ckpt) as s:
            pilots = s.add_pilots(2, memory_gb=0.25)
            with ServingEngine(s, model, batch_size=2, max_len=32,
                               page_tokens=2) as eng:
                eng.deploy(reaper_interval_s=0.02)
                assert eng in s.serving_engines
                reqs = [eng.submit(p, 6) for p in prompts]
                owed = _drain_mid_stream(s, eng, pilots[0])
                eng.drain(timeout=60)
                for p, r in zip(prompts, reqs):
                    assert r.result(timeout=5) == _expected(p, 6)
                st_ = eng.stats()
                assert owed >= 1
                assert st_["drained_replicas"] == 1
                assert pilots[0].id not in st_["replicas"]
                s.manager.policy.undrain(pilots[0].id)
            assert eng not in s.serving_engines     # close deregisters


def test_serving_drain_on_reduced_llama_equals_the_jax_engine():
    """reduced(llama3_2_1b) in fp32 on two pilots, greedy, the JAX init
    carried over: pilot 0's replica is drained while it holds rows, its
    requests re-prefill on pilot 1 from their durable KV pages, and every
    request ends with the JAX engine's tokens (drained the same way) and
    the port's own undisturbed tokens."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as ref_get_config
    from repro.configs.base import reduced as ref_reduced
    from repro.models.model import build_model as ref_build_model
    from repro.serving import ServingEngine as RefEngine

    from repro_torch.carry import params_from_numpy
    from repro_torch.configs import get_config
    from repro_torch.configs.base import reduced
    from repro_torch.models.model import build_model

    rcfg = ref_reduced(ref_get_config("llama3_2_1b"), dtype="float32")
    pcfg = reduced(get_config("llama3_2_1b"), dtype="float32",
                   decode_kernel=False)
    jm, tm = ref_build_model(rcfg), build_model(pcfg)
    jp = jax.tree.map(lambda x: x.astype(jnp.float32),
                      jm.init(jax.random.key(0)))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 256, size=n).astype(np.int32)
               for n in (6, 6, 9, 7, 6, 8)]
    gen = 12

    slow = tm.decode

    def decode(params, cache, tokens, positions):
        time.sleep(0.01)            # the drain lands while rows decode
        return slow(params, cache, tokens, positions)

    import dataclasses
    tm_slow = dataclasses.replace(tm, decode=decode)

    def serve(session_cls, engine_cls, model, params, drain, **kw):
        with tempfile.TemporaryDirectory() as ckpt:
            with session_cls(checkpoint_dir=ckpt, **kw) as s:
                pilots = s.add_pilots(2 if drain else 1, memory_gb=0.25)
                with engine_cls(s, model, params=params, batch_size=2,
                                max_len=48, page_tokens=2) as eng:
                    eng.deploy(reaper_interval_s=0.02)
                    reqs = [eng.submit(p, gen) for p in prompts]
                    owed = (_drain_mid_stream(s, eng, pilots[0])
                            if drain else 0)
                    eng.drain(timeout=120)
                    return ([r.result(timeout=5) for r in reqs],
                            eng.stats(), owed)

    want, _, _ = serve(ref_core.PilotSession, RefEngine, jm, jp, True)
    got, st_, owed = serve(PilotSession, ServingEngine, tm_slow, tp, True,
                           **CPU)
    alone, _, _ = serve(PilotSession, ServingEngine, tm, tp, False, **CPU)
    assert owed >= 1 and st_["drained_replicas"] == 1
    assert st_["recovered_requests"] >= 1
    assert all(len(t) == gen for t in got)
    assert got == want
    assert got == alone


# -- session wiring ----------------------------------------------------------
def test_session_autoscale_stats_surface():
    s = _session(autoscale=True, min_pilots=1, max_pilots=3,
                 autoscaler_kwargs={"interval_s": 0.02},
                 rebalance=True,
                 rebalancer_kwargs={"interval_s": 0.05})
    try:
        s.add_pilots(1, memory_gb=0.05)
        assert s.autoscaler is not None and s.rebalancer is not None
        time.sleep(0.1)                 # a few monitor ticks
        stats = s.stats()
        assert stats["autoscaler"]["min_pilots"] == 1
        assert stats["autoscaler"]["counters"]["ticks"] >= 1
        assert "counters" in stats["rebalancer"]
    finally:
        s.close()
    s.close()
    assert not s.autoscaler._thread.is_alive()
    assert not s.rebalancer._thread.is_alive()


def test_autoscaler_scales_out_on_serving_queue_wait():
    """The monitor loop reads the engine's queue wait, scales out after
    the hysteresis, and the reaper adopts the newcomer as a replica."""
    model = _StubModel(delay=0.01)
    pol = LoadScalingPolicy(serving_wait_s=0.05, hysteresis=2)
    s = _session(autoscale=True, min_pilots=1, max_pilots=2,
                 autoscaler_kwargs={"interval_s": 0.02, "policy": pol})
    try:
        s.add_pilots(1, memory_gb=0.25)
        rng = np.random.default_rng(3)
        prompts = [rng.integers(0, 32, size=4).astype(np.int32)
                   for _ in range(12)]
        with ServingEngine(s, model, batch_size=2, max_len=64,
                           page_tokens=4) as eng:
            eng.deploy(reaper_interval_s=0.02)
            reqs = [eng.submit(p, 20) for p in prompts]
            deadline = time.monotonic() + 20.0
            while len(eng.stats()["replicas"]) < 2:
                assert time.monotonic() < deadline, "no replica adopted"
                time.sleep(0.02)
            eng.drain(timeout=60)
            for p, r in zip(prompts, reqs):
                assert r.result(timeout=5) == _expected(p, 20)
        st_ = s.autoscaler.stats()
        outs = [d for d in st_["decisions"] if d["action"] == "scale-out"]
        assert outs and "serving wait" in outs[0]["reason"]
        assert outs[0]["signals"]["serving_queued"] > 0
    finally:
        s.close()


# -- rebalancer --------------------------------------------------------------
def test_rebalancer_moves_skew_priced_and_avoids_quarantined():
    ic = InterconnectModel(default=Link(gbps=10.0, latency_s=1e-4))
    with _session(interconnect=ic) as s:
        pilots = s.add_pilots(3, memory_gb=0.05, host_memory_gb=0.2)
        donor, receiver, sick = pilots
        rng = np.random.default_rng(11)
        ref = rng.normal(size=(96, 4)).astype(np.float32)
        du = s.data("pts", ref, parts=6)
        s.data_service.replicate_to_pilot(du, donor.id, tier="host")
        s.manager.policy.quarantine(sick.id)
        s.data_service.avoid_pilot(sick.id)
        r = Rebalancer(s, skew=1.2, max_moves=4)
        done = [m for m in r.rebalance_once() if m.status == "done"]
        assert done, "no migration executed"
        for m in done:
            assert m.src == donor.id
            assert m.dst == receiver.id         # never the quarantined one
            assert m.cost_s > 0.0               # priced by the interconnect
            assert m.nbytes > 0
        stats = r.stats()
        assert stats["counters"]["migrations"] == len(done)
        assert stats["counters"]["bytes_moved"] == sum(m.nbytes
                                                       for m in done)
        got = np.concatenate([np.asarray(du.partition(i))
                              for i in range(6)], axis=0)
        np.testing.assert_array_equal(got, ref)


def test_rebalancer_device_tier_migration_keeps_bytes():
    """A migration into the receiver's device tier (the tier the card
    path moves through): replicate lands before the source drops."""
    with _session() as s:
        donor, receiver = s.add_pilots(2, memory_gb=0.05)
        rng = np.random.default_rng(2)
        ref = rng.normal(size=(64, 4)).astype(np.float32)
        du = s.data("pts", ref, parts=4)
        s.data_service.replicate_to_pilot(du, donor.id, tier="device")
        r = Rebalancer(s, skew=1.2, max_moves=1, tier="device")
        (m,) = r.rebalance_once()
        assert m.status == "done" and (m.src, m.dst) == (donor.id,
                                                         receiver.id)
        pds = s.data_service
        key = du._key(m.part)
        assert pds.holders(key) == [receiver.id]
        assert receiver.tier_manager.tier_of(key) == "device"
        np.testing.assert_array_equal(
            np.asarray(receiver.tier_manager.get(key)),
            np.array_split(ref, 4)[m.part])


def test_rebalancer_never_moves_a_partition_twice_to_one_receiver():
    """Two donors holding the same partitions and one empty receiver: the
    plan moves each partition onto the receiver at most once, and a move
    whose receiver already holds the partition drops nothing, so every
    partition keeps its two replicas.  (The JAX package's plan moves
    partitions 0 and 1 from both donors, and its execution drops both
    sources of each: one replica left.)"""
    with _session() as s:
        a, b, c = s.add_pilots(3, memory_gb=0.05, host_memory_gb=0.2)
        pts = np.random.default_rng(0).normal(size=(96, 4)).astype(
            np.float32)
        du = s.data("pts", pts, parts=6)
        pds = s.data_service
        for p in (a, b):
            pds.replicate_to_pilot(du, p.id, tier="host")
        r = Rebalancer(s, skew=1.2, max_moves=8)
        plan = r.plan()
        assert len(plan) == 4
        assert len({(m.part, m.dst) for m in plan}) == len(plan)
        # a repair lands the first move's partition on the receiver first
        first = plan[0]
        pds.replicate(du, first.part, first.dst, "host")
        r.execute(plan)
        assert first.status == "skipped"
        assert [m.status for m in plan[1:]] == ["done"] * 3
        # the skipped move's partition keeps its source beside the
        # repaired copy; every other one moved: two replicas each
        assert [len(pds._live_replicas(du, i)) for i in range(6)] == [
            3 if i == first.part else 2 for i in range(6)]
        assert first.src in pds.holders(du._key(first.part))
        np.testing.assert_array_equal(
            np.concatenate([np.asarray(du.partition(i)) for i in range(6)]),
            pts)


def test_rebalancer_noop_when_balanced():
    with _session() as s:
        s.add_pilots(2, memory_gb=0.05)
        r = Rebalancer(s)
        assert r.plan() == []
        assert r.rebalance_once() == []
