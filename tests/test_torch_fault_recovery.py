"""repro_torch's fault injection against tests/test_fault_recovery.py.

Every case of test_fault_recovery.py runs on the port, on the CPU: pilot
death mid-map_reduce (a simulated pilot whose node is lost, volatile
tiers wiped) and recovery through the durable checkpoint tier.  KMeans
through such a killed pilot must give the JAX package's SSE history on
the same points (fp32, rtol 1e-5): the failed partition group re-runs on
the survivor, reading the replicas the dead pilot lost.
"""
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as ref_core  # noqa: E402
import repro_torch.core as port_core  # noqa: E402
from repro.core.backends.base import \
    register_backend as ref_register  # noqa: E402
from repro.core.backends.simulated import \
    FaultPolicy as RefFaultPolicy  # noqa: E402
from repro.core.backends.simulated import \
    SimulatedClusterBackend as RefSimulated  # noqa: E402
from repro_torch.core import (ComputeDataManager, DataUnit,  # noqa: E402
                              PilotComputeDescription, PilotComputeService,
                              PilotDataService, TierManager, make_backend)
from repro_torch.core.backends.base import register_backend  # noqa: E402
from repro_torch.core.backends.simulated import (  # noqa: E402
    FaultPolicy, SimulatedClusterBackend)
from repro_torch.core.mapreduce import map_reduce  # noqa: E402

CPU = {"device": "cpu"}


@pytest.fixture
def service():
    svc = PilotComputeService()
    yield svc
    svc.cancel_all()


def _desc(backend):
    return PilotComputeDescription(backend=backend, **CPU)


def _home_du(tmp_path, name="duf", parts=6, rows=64):
    """A DU homed on a throw-away file store (rmtree = losing the original
    staging source, so recovery MUST come from the checkpoint tier)."""
    rng = np.random.default_rng(7)
    arr = rng.normal(size=(parts * rows, 4)).astype(np.float32)
    home = tmp_path / f"{name}-home"
    du = DataUnit.from_array(name, arr, parts,
                             {"file": make_backend("file", root=home)},
                             tier="file")
    return du, arr, home


def _attach_tm(pilot, device_budget=None):
    pilot.attach_tier_manager(TierManager(
        {"host": make_backend("host"),
         "device": make_backend("device", **CPU)},
        {"device": device_budget}, promote_threshold=0))
    return pilot


def test_lose_volatile_keeps_only_checkpoint_residents(tmp_path):
    tm = TierManager({"checkpoint": make_backend("checkpoint",
                                                 root=tmp_path / "ck"),
                      "host": make_backend("host"),
                      "device": make_backend("device", **CPU)},
                     {"device": 1024, "host": 1024}, promote_threshold=0)
    for i in range(6):
        tm.put(f"p{i}", np.full(256, i, np.float32), "device")
    spilled = set(tm.resident_keys("checkpoint"))
    assert spilled                          # pressure reached the floor
    lost = set(tm.lose_volatile())
    assert lost == {f"p{i}" for i in range(6)} - spilled
    for k in spilled:                       # durable survivors, intact
        assert tm.tier_of(k) == "checkpoint"
        np.testing.assert_array_equal(tm.get(k),
                                      np.full(256, int(k[1:]), np.float32))
    for k in lost:
        assert tm.tier_of(k) is None
    assert tm.usage("device") == 0 and tm.usage("host") == 0
    assert not tm.backends["device"]._store   # no tensor of it is held
    tm.close()


def test_pilot_loss_then_reads_restore_from_checkpoint(tmp_path, service):
    pds = PilotDataService(checkpoint_dir=str(tmp_path / "ckhome"))
    a = _attach_tm(service.submit_pilot(_desc("inprocess")))
    b = _attach_tm(service.submit_pilot(_desc("inprocess")))
    pds.register_pilot(a)
    pds.register_pilot(b)
    du, arr, home = _home_du(tmp_path)
    pds.register(du, persist=True)
    pds.flush_checkpoints()                 # durability barrier
    du.replicate_to_pilot(a)                # a holds every replica
    shutil.rmtree(home)                     # original staging source gone
    a.tier_manager.lose_volatile()          # node death
    parts = np.array_split(arr, du.num_partitions, axis=0)
    for i in range(du.num_partitions):
        got = np.asarray(du.partition(i, pilot=b))
        np.testing.assert_array_equal(got, parts[i])
    assert pds.counters["checkpoint_restores"] >= du.num_partitions
    pds.close()


def test_map_reduce_retries_failed_group_onto_survivor(tmp_path, service):
    register_backend(SimulatedClusterBackend(
        substrate="slurm",
        policy=FaultPolicy(fail_devices_at=0, lose_memory=True)))
    pds = PilotDataService(checkpoint_dir=str(tmp_path / "ckhome"))
    flaky = _attach_tm(service.submit_pilot(_desc("simulated")))
    backup = _attach_tm(service.submit_pilot(_desc("inprocess")))
    pds.register_pilot(flaky)
    pds.register_pilot(backup)
    manager = ComputeDataManager(service)

    du, arr, home = _home_du(tmp_path, parts=6)
    pds.register(du, persist=True)
    pds.flush_checkpoints()
    du.replicate_to_pilot(flaky, parts=[0, 1, 2])
    du.replicate_to_pilot(backup, parts=[3, 4, 5])
    shutil.rmtree(home)                     # checkpoint is the only source

    reference = float(np.asarray(arr, np.float64).sum())
    total = map_reduce(du, lambda p: np.asarray(p, np.float64).sum(),
                       lambda x, y: x + y, manager=manager, jit_map=False,
                       retries=2)
    assert total == pytest.approx(reference, rel=1e-6)
    assert flaky.state.value == "Failed"
    assert flaky.tier_manager.usage("device") == 0
    assert pds.counters["checkpoint_restores"] > 0
    parts = np.array_split(arr, du.num_partitions, axis=0)
    for i in range(du.num_partitions):
        np.testing.assert_array_equal(
            np.asarray(du.partition(i, pilot=backup)), parts[i])
    pds.close()


def test_map_reduce_raises_when_retries_exhausted(tmp_path, service):
    register_backend(SimulatedClusterBackend(
        substrate="slurm",
        policy=FaultPolicy(fail_devices_at=0, lose_memory=True)))
    pds = PilotDataService(checkpoint_dir=str(tmp_path / "ckhome"))
    flaky = _attach_tm(service.submit_pilot(_desc("simulated")))
    pds.register_pilot(flaky)
    manager = ComputeDataManager(service)
    du, arr, home = _home_du(tmp_path, parts=2)
    pds.register(du, persist=True)
    with pytest.raises(RuntimeError, match="lost its devices"):
        map_reduce(du, lambda p: float(np.asarray(p).sum()),
                   lambda x, y: x + y, manager=manager, jit_map=False,
                   retries=1)
    pds.close()


def test_spilled_partitions_survive_pilot_death_without_persist(tmp_path,
                                                                service):
    store_dir = str(tmp_path / "spill-home")
    pds = PilotDataService(checkpoint_dir=store_dir)
    du, arr, home = _home_du(tmp_path, parts=4)
    part_bytes = du.nbytes() // 4
    a = service.submit_pilot(_desc("inprocess"))
    a.attach_tier_manager(TierManager(
        {"checkpoint": make_backend("checkpoint", root=store_dir),
         "host": make_backend("host"),
         "device": make_backend("device", **CPU)},
        {"device": part_bytes + part_bytes // 2, "host": part_bytes // 2},
        promote_threshold=0))
    b = _attach_tm(service.submit_pilot(_desc("inprocess")))
    pds.register_pilot(a)
    pds.register_pilot(b)
    pds.register(du)
    du.replicate_to_pilot(a)                # overflow demotes to checkpoint
    spilled = [k for k in a.tier_manager.resident_keys("checkpoint")]
    assert spilled
    a.tier_manager.close()                  # flush spill writes, fsync
    shutil.rmtree(home)
    a.tier_manager.lose_volatile()
    pds.unregister_pilot(a.id)              # the pilot is fully gone
    parts = np.array_split(arr, du.num_partitions, axis=0)
    for i, key in enumerate(du._key(j) for j in range(4)):
        if key in spilled:
            np.testing.assert_array_equal(
                np.asarray(du.partition(i, pilot=b)), parts[i])
    assert pds.counters["checkpoint_restores"] >= len(spilled)
    pds.close()


# -- KMeans through a killed pilot: the JAX package's SSE history ----------
def _kmeans_through_loss(pkg, pts, tier, fail_at):
    """Two pilots hold the points (replication 2, half the partitions
    homed on each); the simulated one loses its node (and its volatile
    tiers) after `fail_at` compute units, so its group of some iteration
    fails and re-runs on the in-process survivor."""
    kw = CPU if pkg is port_core else {}
    policy_cls, backend_cls, register = (
        (FaultPolicy, SimulatedClusterBackend, register_backend)
        if pkg is port_core else (RefFaultPolicy, RefSimulated,
                                  ref_register))
    register(backend_cls(substrate="slurm", policy=policy_cls(
        fail_devices_at=fail_at, lose_memory=True)))
    with pkg.PilotSession(**kw) as s:
        flaky = s.add_pilot(backend="simulated", startup_seconds=0.01,
                            memory_gb=0.05)
        s.add_pilot(memory_gb=0.05)
        du = s.data("points", pts, parts=4, replication=2)
        for p in s.pilots:
            s.data_service.replicate_to_pilot(du, p.id, tier=tier)
        res = s.kmeans(du, k=5, iters=5, seed=0)
        died = flaky.state.value == "Failed"
        lost = flaky.tier_manager.usage(tier)
    register(backend_cls())
    return res.sse_history, died, lost


@pytest.mark.parametrize("tier,fail_at", [("device", 0), ("device", 2),
                                          ("host", 1)])
def test_kmeans_through_a_killed_pilot_equals_the_reference(tier, fail_at):
    pts = np.random.default_rng(0).normal(size=(2000, 8)).astype(np.float32)
    want, ref_died, _ = _kmeans_through_loss(ref_core, pts, tier, fail_at)
    got, died, lost = _kmeans_through_loss(port_core, pts, tier, fail_at)
    assert ref_died and died                # the node really was lost
    assert lost == 0                        # and its volatile tier with it
    assert len(got) == 5
    np.testing.assert_allclose(got, want, rtol=1e-5)
