"""repro_torch's self-healing sessions against tests/test_supervisor.py.

Every case of test_supervisor.py runs on the port, on the CPU, through
the simulated backend (``repro_torch.core.backends.simulated``): failure
detection, quarantine, respawn, replication repair and the recovery
races.  Where the outcome is deterministic (the backoff schedule, the phi
detector's suspicion on a fixed beat trace, the simulated substrates'
latency models) the port and the JAX package must give the same numbers;
the timing-driven chaos cases (stall, kill, racing close) assert the
invariants test_supervisor.py asserts, not equal traces.
"""
import tempfile
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

import repro.core as ref_core  # noqa: E402
import repro_torch.core as port_core  # noqa: E402
from repro_torch.core import (Backoff, ComputeDataManager,  # noqa: E402
                              ComputeUnitDescription, DataUnit,
                              FailureDetector, PilotComputeDescription,
                              PilotComputeService, PilotDataService,
                              PilotSession, PilotSupervisor, TierManager,
                              make_backend)
from repro_torch.core.backends.base import (get_backend,  # noqa: E402
                                            register_backend)
from repro_torch.core.backends.simulated import (  # noqa: E402
    SUBSTRATES, ChaosEvent, ChaosPolicy, SimulatedClusterBackend)
from repro_torch.core.pilot import State  # noqa: E402

CPU = {"device": "cpu"}


@pytest.fixture
def service():
    svc = PilotComputeService()
    yield svc
    svc.cancel_all()


def _desc(**kw):
    return PilotComputeDescription(**CPU, **kw)


def _attach_tm(pilot):
    pilot.attach_tier_manager(TierManager(
        {"host": make_backend("host"),
         "device": make_backend("device", **CPU)},
        {}, promote_threshold=0))
    return pilot


def _chaos_backend(events, target_index=0, lose_memory=True):
    """Register a fresh simulated backend carrying a chaos schedule for
    its target_index-th provisioned pilot."""
    be = SimulatedClusterBackend(
        substrate="slurm",
        policy=ChaosPolicy(lose_memory=lose_memory, events=tuple(events),
                           target_index=target_index))
    register_backend(be)
    return be


def _session(**kw):
    return PilotSession(supervise=True, **CPU, **kw)


# -- deterministic parts: the same numbers as the JAX package ---------------
def test_substrate_latency_models_equal_the_reference():
    from repro.core.backends.simulated import SUBSTRATES as REF
    assert SUBSTRATES == REF
    # the paper's Fig. 6 order: warm Spark < HPC agent < YARN < cloud VM
    assert (SUBSTRATES["slurm"] < SUBSTRATES["spark"] < SUBSTRATES["yarn"]
            < SUBSTRATES["cloud"])


def test_backoff_without_jitter_equals_the_reference():
    ours = Backoff(base_s=0.01, cap_s=0.08, factor=2.0, jitter=0.0)
    theirs = ref_core.Backoff(base_s=0.01, cap_s=0.08, factor=2.0,
                              jitter=0.0)
    assert [ours.delay(a) for a in range(10)] == \
        [theirs.delay(a) for a in range(10)]


def test_failure_detector_phi_equals_the_reference():
    rng = np.random.default_rng(0)
    beats = np.cumsum(rng.uniform(0.05, 0.15, size=12))
    probes = beats[-1] + np.array([0.01, 0.1, 0.3, 0.8, 2.0, 6.0])
    phis = []
    for pkg in (ref_core, port_core):
        det = pkg.FailureDetector(min_interval_s=0.1)
        for b in beats:
            det.observe("p", last_beat=float(b), now=float(b))
        phis.append([det.phi("p", now=float(t)) for t in probes])
    assert phis[1] == phis[0]


# -- unit: backoff + detector -----------------------------------------------
def test_backoff_grows_is_capped_and_jittered():
    b = Backoff(base_s=0.01, cap_s=0.08, factor=2.0, jitter=0.5)
    for attempt in range(10):
        raw = min(0.08, 0.01 * 2 ** attempt)
        for _ in range(20):
            d = b.delay(attempt)
            assert raw * 0.5 - 1e-12 <= d <= raw + 1e-12
    # jitter actually spreads (not a constant)
    assert len({round(b.delay(3), 6) for _ in range(50)}) > 1
    # no-jitter backoff is deterministic
    nb = Backoff(base_s=0.01, cap_s=0.08, jitter=0.0)
    assert nb.delay(0) == 0.01 and nb.delay(2) == 0.04 and nb.delay(9) == 0.08


def test_failure_detector_phi_rises_with_silence():
    det = FailureDetector(min_interval_s=0.1)
    # regular beats at 0.1s intervals
    for k in range(5):
        det.observe("p", last_beat=k * 0.1, now=k * 0.1)
    assert det.phi("p", now=0.45) <= 1.0     # half an interval late: calm
    assert det.phi("p", now=0.8) >= 3.0      # 4 intervals of silence
    assert det.phi("p", now=4.0) >= 30.0     # definitely dead
    det.forget("p")
    assert det.phi("p", now=5.0) == 0.0      # unknown pilot: no suspicion


def test_health_surface_both_backends(service):
    _chaos_backend([])
    for backend in ("inprocess", "simulated"):
        p = service.submit_pilot(_desc(backend=backend,
                                       startup_seconds=0.01))
        h = get_backend(backend).health(p)
        assert h["alive"] and h["state"] == "Running"
        assert h["pilot"] == p.id and not h["busy"]
        assert p.devices == [torch.device("cpu")]
        age0 = h["heartbeat_age_s"]
        time.sleep(0.12)    # the idle worker loop keeps beating
        h2 = get_backend(backend).health(p)
        assert h2["heartbeat_age_s"] < 0.12 or h2["heartbeat_age_s"] >= age0


def test_wait_idle_wakes_on_completion_not_poll_tick(service):
    p = service.submit_pilot(_desc(backend="inprocess"))
    manager = ComputeDataManager(service)
    cu = manager.submit(ComputeUnitDescription(
        fn=lambda: time.sleep(0.15) or 41))
    t0 = time.monotonic()
    assert p.wait_idle(timeout=5.0)
    waited = time.monotonic() - t0
    assert cu.result() == 41
    assert waited < 2.0                      # woke with the CU, not at 5s
    # already idle: returns immediately
    t0 = time.monotonic()
    assert p.wait_idle(timeout=5.0)
    assert time.monotonic() - t0 < 0.05
    # a busy pilot times out honestly
    manager.submit(ComputeUnitDescription(fn=lambda: time.sleep(0.5)))
    assert not p.wait_idle(timeout=0.05)
    assert p.wait_idle(timeout=5.0)


# -- quarantine: before any task routes to the suspect ----------------------
def test_stalled_pilot_quarantined_before_any_new_task_schedules(service):
    """The detector quarantines a stalled pilot while it still LOOKS
    alive (state Running), and from that point no new task is scheduled
    onto it."""
    _chaos_backend([ChaosEvent(at_s=0.15, action="stall", duration_s=2.0)])
    victim = _attach_tm(service.submit_pilot(_desc(
        backend="simulated", startup_seconds=0.01)))
    survivor = _attach_tm(service.submit_pilot(_desc(backend="inprocess")))
    manager = ComputeDataManager(service)
    sup = PilotSupervisor(compute=service, manager=manager,
                          interval_s=0.02, min_heartbeat_s=0.05,
                          suspect_phi=3.0, dead_phi=1e9,
                          auto_respawn=False).start()
    try:
        deadline = time.monotonic() + 5.0
        while victim.id not in sup.quarantined:
            assert time.monotonic() < deadline, "stall never suspected"
            time.sleep(0.01)
        assert victim.state == State.RUNNING
        assert victim.id in manager.policy.quarantined
        for _ in range(16):
            cu = manager.submit(ComputeUnitDescription(fn=lambda: 1))
            assert cu.pilot_id == survivor.id
            assert cu.result(timeout=10) == 1
        batch = manager.submit_tasks([lambda: 2] * 32)
        assert batch.results(timeout=10) == [2] * 32
        assert all(t.pilot_id == survivor.id for t in batch)
    finally:
        sup.close()


def test_quarantine_fails_closed_then_readmits(service):
    p = _attach_tm(service.submit_pilot(_desc(backend="inprocess")))
    manager = ComputeDataManager(service)
    manager.policy.quarantine(p.id)
    assert manager.eligible_pilots() == []
    with pytest.raises(TimeoutError):
        manager.select_pilot(ComputeUnitDescription(fn=lambda: 0),
                             timeout=0.2)
    manager.policy.readmit(p.id)
    assert manager.select_pilot(
        ComputeUnitDescription(fn=lambda: 0), timeout=1.0) is p


# -- respawn ----------------------------------------------------------------
def test_kill_respawns_pilot_from_its_own_description():
    _chaos_backend([ChaosEvent(at_s=0.2, action="kill")])
    s = _session(supervisor_kwargs={"interval_s": 0.02,
                                    "min_heartbeat_s": 0.05})
    try:
        victim = s.add_pilot(backend="simulated", startup_seconds=0.01,
                             memory_gb=0.01, host_memory_gb=0.03,
                             affinity="rack0")
        s.add_pilot(memory_gb=0.01)
        deadline = time.monotonic() + 8.0
        while not s.supervisor.respawns:
            assert time.monotonic() < deadline, "kill never respawned"
            time.sleep(0.02)
        ev = s.supervisor.respawns[0]
        assert ev.old_pilot == victim.id and ev.new_pilot
        new = s.compute.pilots[ev.new_pilot]
        assert new.desc is victim.desc
        assert new.desc.affinity == "rack0"
        assert new.state == State.RUNNING
        assert victim.id not in s.compute.pilots
        assert not s.data_service.knows(victim.id)
        assert s.data_service.knows(new.id)
        assert victim.id not in s.supervisor.quarantined
        assert s.run(lambda: 7).result(timeout=10) == 7
    finally:
        s.close()


def test_deliberate_release_is_not_mistaken_for_death():
    _chaos_backend([])
    s = _session(supervisor_kwargs={"interval_s": 0.02,
                                    "min_heartbeat_s": 0.05})
    try:
        a = s.add_pilot(memory_gb=0.01)
        s.add_pilot(memory_gb=0.01)
        s.release(a)
        time.sleep(0.3)     # give the monitor time to misfire (it must not)
        assert not s.supervisor.respawns
        assert len(s.pilots) == 1
    finally:
        s.close()


# -- replication repair -----------------------------------------------------
def test_repair_restores_replication_target_after_pilot_loss():
    _chaos_backend([ChaosEvent(at_s=0.3, action="kill")])
    s = _session(supervisor_kwargs={"interval_s": 0.02,
                                    "min_heartbeat_s": 0.05,
                                    "repair_interval_s": 0.03})
    try:
        victim = s.add_pilot(backend="simulated", startup_seconds=0.01,
                             memory_gb=0.01, host_memory_gb=0.05)
        s.add_pilots(2, memory_gb=0.01, host_memory_gb=0.05)
        rng = np.random.default_rng(3)
        arr = rng.normal(size=(48, 4)).astype(np.float32)
        du = s.data("pts", arr, parts=6, replication=2)
        s.data_service.replicate_to_pilot(du, victim.id, tier="host")
        deadline = time.monotonic() + 10.0
        while True:
            rs = s.data_service.replication_stats()["pts"]
            if (s.supervisor.respawns and rs["under"] == 0
                    and all(c >= 2 for c in rs["per_partition"].values())):
                break
            assert time.monotonic() < deadline, f"repair incomplete: {rs}"
            time.sleep(0.05)
        assert s.data_service.counters["repairs"] > 0
        parts = np.array_split(arr, 6, axis=0)
        for i in range(6):
            np.testing.assert_array_equal(np.asarray(du.partition(i)),
                                          parts[i])
        st_ = s.stats()["supervisor"]
        assert st_["repair_queue_depth"] == 0
        assert st_["replication"]["pts"]["under"] == 0
    finally:
        s.close()


@settings(max_examples=6, deadline=None)
@given(quarantined=st.lists(st.integers(0, 2), min_size=0, max_size=3),
       wipe=st.integers(0, 2))
def test_repair_never_reads_from_quarantined_pilot(quarantined, wipe):
    """Whatever subset of the fleet is quarantined and whoever lost its
    volatile tiers, replication repair only ever reads from
    non-quarantined managers (the checkpoint home is the fallback)."""
    svc = PilotComputeService()
    try:
        pilots = [_attach_tm(svc.submit_pilot(_desc(backend="inprocess")))
                  for _ in range(3)]
        with tempfile.TemporaryDirectory() as tmp:
            pds = PilotDataService(checkpoint_dir=tmp + "/ck")
            try:
                for p in pilots:
                    pds.register_pilot(p)
                arr = np.arange(64, dtype=np.float32).reshape(16, 4)
                du = DataUnit.from_array("prop", arr, 4,
                                         {"host": make_backend("host")},
                                         tier="host")
                pds.register(du, persist=True, replication=2)
                pds.flush_checkpoints()
                for p in pilots:
                    pds.replicate_to_pilot(du, p.id, tier="host")
                reads = []
                for p in pilots:
                    tm, pid = p.tier_manager, p.id
                    orig = tm.get
                    tm.get = (lambda key, _o=orig, _pid=pid:
                              (reads.append(_pid), _o(key))[1])
                pilots[wipe].tier_manager.lose_volatile()
                for qi in set(quarantined):
                    pds.avoid_pilot(pilots[qi].id)
                reads.clear()
                pds.repair_once()
                bad = {pilots[qi].id for qi in set(quarantined)}
                assert not (set(reads) & bad), (
                    f"repair read from quarantined {set(reads) & bad}")
                parts = np.array_split(arr, 4, axis=0)
                for i in range(4):
                    for pid in pds.live_holders(du._key(i)):
                        tm = pds.manager_for(pid)
                        if tm.tier_of(du._key(i)) is not None:
                            np.testing.assert_array_equal(
                                np.asarray(tm.get(du._key(i))), parts[i])
            finally:
                pds.close()
    finally:
        svc.cancel_all()


# -- recovery races ---------------------------------------------------------
def test_lose_volatile_concurrent_with_checkpoint_flush(tmp_path, service):
    """Node death racing a checkpoint flush leaves every partition
    recoverable, byte-identically."""
    pds = PilotDataService(checkpoint_dir=str(tmp_path / "ck"))
    a = _attach_tm(service.submit_pilot(_desc(backend="inprocess")))
    b = _attach_tm(service.submit_pilot(_desc(backend="inprocess")))
    pds.register_pilot(a)
    pds.register_pilot(b)
    rng = np.random.default_rng(11)
    arr = rng.normal(size=(64, 4)).astype(np.float32)
    du = DataUnit.from_array("race", arr, 8,
                             {"host": make_backend("host")}, tier="host")
    pds.register(du)
    pds.replicate_to_pilot(du, a.id, tier="host")
    errors = []

    def _flush_loop():
        try:
            for _ in range(10):
                pds.persist(du)
                pds.flush_checkpoints()
        except Exception as e:      # noqa: BLE001
            errors.append(e)

    t = threading.Thread(target=_flush_loop)
    t.start()
    time.sleep(0.005)
    a.tier_manager.lose_volatile()          # node death mid-flush
    t.join(30)
    assert not errors, errors
    parts = np.array_split(arr, 8, axis=0)
    for i in range(8):
        np.testing.assert_array_equal(
            np.asarray(pds.read(du, i, b.id, pull_tier="host")), parts[i])
    pds.close()


def test_session_close_during_inflight_respawn():
    """session.close() racing an in-flight respawn neither deadlocks nor
    leaks a pilot."""
    _chaos_backend([ChaosEvent(at_s=0.1, action="kill")])
    s = _session(supervisor_kwargs={"interval_s": 0.02,
                                    "min_heartbeat_s": 0.05})
    victim = s.add_pilot(backend="simulated", startup_seconds=0.4,
                         memory_gb=0.01)
    deadline = time.monotonic() + 5.0
    while victim.state == State.RUNNING:    # wait for the kill to land
        assert time.monotonic() < deadline
        time.sleep(0.01)
    time.sleep(0.05)                        # let the monitor start respawn
    t0 = time.monotonic()
    s.close()                               # races the in-flight respawn
    assert time.monotonic() - t0 < 10.0
    assert s.closed
    assert len(s.pilots) == 0               # nothing leaked past close
    for ev in s.supervisor.respawns:
        assert ev.old_pilot == victim.id
    s.close()                               # idempotent


# -- observability ----------------------------------------------------------
def test_session_stats_surface_supervisor_observability():
    _chaos_backend([])
    s = _session(supervisor_kwargs={"interval_s": 0.02})
    try:
        p = s.add_pilot(memory_gb=0.01)
        s.data("obs", np.ones((8, 2), np.float32), parts=2, replication=1)
        time.sleep(0.15)
        st_ = s.stats()
        sup = st_["supervisor"]
        assert p.id in sup["pilots"]
        row = sup["pilots"][p.id]
        assert {"state", "heartbeat_age_s", "phi", "quarantined"} <= set(row)
        assert row["state"] == "Running" and not row["quarantined"]
        assert sup["quarantined"] == [] and sup["respawns"] == []
        assert "repair_queue_depth" in sup
        assert sup["replication"]["obs"]["target"] == 1
        assert set(sup["replication"]["obs"]["per_partition"]) == {0, 1}
    finally:
        s.close()
