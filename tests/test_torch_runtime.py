"""repro_torch.runtime against tests/test_runtime.py and the JAX package.

Stragglers, the resilient runner and the elastic device grid, on the CPU:

  * ``StragglerMonitor.cutoff`` gives the JAX package's cutoff on the
    same durations, and ``plan_mesh`` its shapes for 255/16, 256/16 and
    7/16 survivors;
  * ``ResilientRunner`` under ``FaultPolicy(fail_devices_at=4)`` ends in
    the JAX package's state with the same restored steps;
  * the runner over the port's own train step (which updates params and
    AdamW moments in place, and saves with ``blocking=False`` right after)
    ends bit for bit where an uninterrupted run ends: the checkpoint's
    host snapshot is taken before ``save`` returns;
  * ``ElasticController`` grows and shrinks a session's fleet through the
    autoscaler and re-forms its grid over the live pilots' devices.

``test_elastic_reshard_state_roundtrip``'s counterpart runs
``reshard_state`` over 4 gloo ranks (tests/_torch_dist.py) on the meshes
``build_mesh`` forms over ranks, (4, 1) and (2, 2): each rank holds its
slice of the host array, and the gathered state equals it.  The
``gpu`` cases (a killed pilot's device memory is freed; a migration
between two pilots on the card keeps its bytes) skip without a card, and
import nothing of JAX, so ``pytest --noconftest -m gpu`` runs them where
JAX is absent.
"""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.core import (ComputeDataManager,  # noqa: E402
                              ComputeUnitDescription, PilotComputeDescription,
                              PilotComputeService, PilotSession)
from repro_torch.core.backends.base import register_backend  # noqa: E402
from repro_torch.core.backends.simulated import (  # noqa: E402
    ChaosEvent, ChaosPolicy, FaultPolicy, SimulatedClusterBackend)
from repro_torch.core.pilot import State  # noqa: E402
from repro_torch.runtime.elastic import (DeviceGrid,  # noqa: E402
                                         ElasticController, build_mesh,
                                         plan_mesh)
from repro_torch.runtime.fault_tolerance import ResilientRunner  # noqa: E402
from repro_torch.runtime.stragglers import (StragglerMonitor,  # noqa: E402
                                            run_speculative)

CPU = {"device": "cpu"}


@pytest.fixture
def service():
    svc = PilotComputeService()
    yield svc
    svc.cancel_all()


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


# -- stragglers --------------------------------------------------------------
def test_straggler_monitor_flags_outlier():
    mon = StragglerMonitor(threshold=3.0, min_samples=5)
    mon.durations.extend([0.1] * 10)

    class FakeCU:
        id = "slow"
        start_time = time.monotonic() - 5.0
        end_time = 0.0
    assert mon.is_straggling(FakeCU())
    assert "slow" in mon.flagged


@pytest.mark.parametrize("seed,n,threshold", [(0, 4, 3.0), (1, 5, 3.0),
                                              (2, 40, 2.0), (3, 9, 4.5)])
def test_straggler_cutoff_equals_the_reference(seed, n, threshold):
    from repro.runtime.stragglers import StragglerMonitor as Ref
    d = np.random.default_rng(seed).lognormal(-3.0, 0.6, size=n).tolist()
    if seed == 3:
        d = [0.02] * n          # zero MAD: the 5%-of-median floor
    ours, theirs = StragglerMonitor(threshold=threshold), Ref(
        threshold=threshold)
    ours.durations.extend(d)
    theirs.durations.extend(d)
    assert ours.cutoff() == theirs.cutoff()
    assert (ours.cutoff() is None) == (n < 5)


def test_speculative_execution_backup_wins(service):
    register_backend(SimulatedClusterBackend(
        substrate="slurm",
        policy=FaultPolicy(straggle_cu_ids=frozenset({"lag"}),
                           straggle_seconds=2.0)))
    service.submit_pilot(PilotComputeDescription(backend="simulated", **CPU))
    service.submit_pilot(PilotComputeDescription(backend="inprocess", **CPU))
    manager = ComputeDataManager(service)
    mon = StragglerMonitor(threshold=3.0, min_samples=3)
    mon.durations.extend([0.02] * 5)
    t0 = time.monotonic()
    out, info = run_speculative(
        manager, ComputeUnitDescription(fn=lambda: "done", name="lag"), mon)
    assert out == "done"
    assert info["launched"] >= 2          # a backup was launched
    assert time.monotonic() - t0 < 2.0         # didn't wait for the straggler
    register_backend(SimulatedClusterBackend())


# -- the resilient runner ----------------------------------------------------
def test_resilient_runner_recovers_from_pilot_loss(service, tmp_path):
    register_backend(SimulatedClusterBackend(
        substrate="yarn", policy=FaultPolicy(fail_devices_at=4)))
    ckpt = CheckpointManager(tmp_path)
    runner = ResilientRunner(
        service, PilotComputeDescription(backend="simulated", **CPU),
        ckpt, checkpoint_every=2, max_recoveries=3)

    def step_fn(state, batch):
        return {"x": state["x"] + batch}, {"x": state["x"]}

    state = {"x": torch.tensor(0.0)}
    final, metrics = runner.run(state, step_fn, num_steps=10,
                                batch_fn=lambda i: torch.tensor(1.0))
    assert float(final["x"]) == 10.0       # exactly-once effective progress
    assert len(runner.recoveries) >= 1     # recovery actually happened
    assert runner.recoveries[0].restored_step <= runner.recoveries[0].step
    register_backend(SimulatedClusterBackend())


def test_resilient_runner_equals_the_reference(tmp_path):
    """The same step function, fault policy and checkpoint cadence: the
    same final state, the same recoveries (step, restored step) and the
    same metrics, step for step."""
    import jax.numpy as jnp
    from repro.checkpoint.checkpoint import CheckpointManager as RefCkpt
    from repro.core import PilotComputeDescription as RefDesc
    from repro.core import PilotComputeService as RefService
    from repro.core.backends.base import register_backend as ref_register
    from repro.core.backends.simulated import FaultPolicy as RefPolicy
    from repro.core.backends.simulated import \
        SimulatedClusterBackend as RefSimulated
    from repro.runtime.fault_tolerance import \
        ResilientRunner as RefRunner

    inc = np.random.default_rng(0).normal(size=10).astype(np.float32)

    def run(pkg):
        if pkg == "ref":
            ref_register(RefSimulated(substrate="yarn",
                                      policy=RefPolicy(fail_devices_at=4)))
            svc, desc = RefService(), RefDesc(backend="simulated")
            runner_cls, ckpt = RefRunner, RefCkpt(tmp_path / "ref")
            state, batch = {"x": jnp.float32(0)}, lambda i: jnp.float32(
                inc[i])
        else:
            register_backend(SimulatedClusterBackend(
                substrate="yarn", policy=FaultPolicy(fail_devices_at=4)))
            svc = PilotComputeService()
            desc = PilotComputeDescription(backend="simulated", **CPU)
            runner_cls, ckpt = ResilientRunner, CheckpointManager(
                tmp_path / "port")
            state, batch = {"x": torch.tensor(0.0)}, lambda i: torch.tensor(
                inc[i])
        try:
            runner = runner_cls(svc, desc, ckpt, checkpoint_every=2,
                                max_recoveries=3)
            final, metrics = runner.run(
                state, lambda s, b: ({"x": s["x"] + b}, {"x": s["x"]}),
                num_steps=10, batch_fn=batch)
        finally:
            svc.cancel_all()
        return (float(final["x"]), [float(m["x"]) for m in metrics],
                [(e.step, e.restored_step) for e in runner.recoveries])

    want, got = run("ref"), run("port")
    register_backend(SimulatedClusterBackend())
    assert got == want
    assert got[2], "no recovery happened"
    np.testing.assert_allclose(got[0], float(inc.astype(np.float64).sum()),
                               rtol=1e-6)


def _train_setup():
    from repro_torch.configs.base import ParallelConfig, TrainConfig
    from repro_torch.launch.train import scaled_config
    from repro_torch.models.model import build_model
    from repro_torch.train import steps as steps_mod
    cfg = scaled_config("llama3_2_1b", "smoke")
    model = build_model(cfg)
    pcfg, tcfg = ParallelConfig(), TrainConfig(learning_rate=1e-2,
                                               total_steps=10,
                                               warmup_steps=2)
    step = steps_mod.make_train_step(model, pcfg, tcfg)

    def init():
        return steps_mod.init_train_state(
            model, torch.Generator().manual_seed(0), pcfg, device="cpu")

    def batch(i):
        toks = np.random.default_rng(100 + i).integers(
            0, cfg.vocab_size, (2, 17)).astype(np.int64)
        t = torch.from_numpy(toks)
        return {"tokens": t[:, :-1], "labels": t[:, 1:]}
    return step, init, batch


def test_resilient_runner_over_the_in_place_train_step(tmp_path):
    """12 steps of the port's train step (donated state: AdamW writes in
    place) through a pilot that dies after 7 compute units, saving every
    4 steps with blocking=False: the final params and moments equal an
    uninterrupted run's bit for bit, and so do the losses of the steps
    both runs took from the same state."""
    from repro_torch.models.common import tree_leaves
    step, init, batch = _train_setup()
    svc, plain_svc = PilotComputeService(), PilotComputeService()
    try:
        register_backend(SimulatedClusterBackend(
            substrate="slurm", policy=FaultPolicy(fail_devices_at=7)))
        runner = ResilientRunner(
            svc, PilotComputeDescription(backend="simulated", **CPU),
            CheckpointManager(tmp_path / "ck"), checkpoint_every=4,
            max_recoveries=3)
        got, metrics = runner.run(init(), step, num_steps=12,
                                  batch_fn=batch)
        plain = ResilientRunner(
            plain_svc, PilotComputeDescription(backend="inprocess", **CPU),
            CheckpointManager(tmp_path / "plain"), checkpoint_every=100)
        want, want_metrics = plain.run(init(), step, num_steps=12,
                                       batch_fn=batch)
    finally:
        svc.cancel_all()
        plain_svc.cancel_all()
        register_backend(SimulatedClusterBackend())
    # each provisioned pilot dies after 7 units: 0-6, restore 4; 4-10,
    # restore 8; 8-11
    assert [(e.step, e.restored_step) for e in runner.recoveries] == [
        (7, 4), (11, 8)]
    assert not plain.recoveries
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert torch.equal(a, b)
    losses = [float(m["loss"]) for m in metrics]
    want_losses = [float(m["loss"]) for m in want_metrics]
    assert losses == want_losses[:7] + want_losses[4:11] + want_losses[8:]


def test_resilient_runner_loss_before_the_first_checkpoint(tmp_path):
    """A pilot lost before the first periodic checkpoint: the runner
    resumes from the starting state (saved before the first step), so
    progress stays exactly-once.  The JAX package's runner restarts the
    step count at 0 but keeps the advanced state, and so counts the lost
    steps twice; the port's repair."""
    register_backend(SimulatedClusterBackend(
        substrate="slurm", policy=FaultPolicy(fail_devices_at=3)))
    svc = PilotComputeService()
    try:
        desc = PilotComputeDescription(backend="simulated", **CPU)
        runner = ResilientRunner(svc, desc, CheckpointManager(tmp_path),
                                 checkpoint_every=100, max_recoveries=1)
        # the job starts on a node that dies after 3 steps; the
        # replacement comes from a healthy allocation
        runner.pilot = svc.submit_pilot(desc)
        register_backend(SimulatedClusterBackend(substrate="slurm"))
        final, metrics = runner.run(
            {"x": torch.tensor(0.0)},
            lambda s, b: ({"x": s["x"] + b}, {"x": s["x"]}), num_steps=5,
            batch_fn=lambda i: torch.tensor(float(i + 1)))
    finally:
        svc.cancel_all()
        register_backend(SimulatedClusterBackend())
    assert [(e.step, e.restored_step) for e in runner.recoveries] == [(3, 0)]
    assert float(final["x"]) == 1 + 2 + 3 + 4 + 5
    assert [float(m["x"]) for m in metrics] == [0, 1, 3, 0, 1, 3, 6, 10]


# -- the elastic grid --------------------------------------------------------
def test_plan_mesh_degrades_gracefully():
    p = plan_mesh(256, 16)
    assert p.shape == (16, 16) and p.dropped_devices == 0
    p = plan_mesh(255, 16)          # lost one device
    assert p.dropped_devices < 16   # wastes at most a partial row
    assert (p.shape[0] * p.shape[1]) + p.dropped_devices == 255
    p = plan_mesh(7, 16)            # fewer survivors than model-parallel
    assert p.shape[1] <= 7


@pytest.mark.parametrize("n,mp", [(255, 16), (256, 16), (7, 16), (12, 4),
                                  (1, 8)])
def test_plan_mesh_equals_the_reference(n, mp):
    from repro.runtime.elastic import plan_mesh as ref_plan
    ours, theirs = plan_mesh(n, mp), ref_plan(n, mp)
    assert (ours.shape, ours.axes, ours.dropped_devices) == (
        theirs.shape, theirs.axes, theirs.dropped_devices)


def test_build_mesh_lays_devices_on_the_plan_axes():
    devs = [torch.device("cuda", i) for i in range(6)]
    grid = build_mesh(devs, plan_mesh(6, 4))     # 4 does not divide 6: 3
    assert isinstance(grid, DeviceGrid)
    assert grid.shape == (2, 3) and grid.axes == ("data", "model")
    assert grid.devices[1, 0] == torch.device("cuda", 3)
    grid = build_mesh(devs[:5], plan_mesh(5, 2))  # prime: (5, 1)
    assert grid.shape == (5, 1) and grid.size == 5


def test_elastic_reshard_state_roundtrip(tmp_path):
    from _torch_dist import spawn
    spawn("""
        from repro_torch.models.common import ParamSpec
        from repro_torch.parallel.sharding import AxisRules
        from repro_torch.runtime.elastic import (build_mesh, plan_mesh,
                                                 reshard_state)
        spec = {"w": ParamSpec((8, 16), ("embed", "mlp"))}
        host = {"w": np.arange(128, dtype=np.float32).reshape(8, 16)}
        for mp, local in ((1, (2, 16)), (2, (4, 8))):
            mesh = build_mesh(list(range(world)), plan_mesh(world, mp))
            out = reshard_state(host, spec, mesh, AxisRules())
            assert tuple(out["w"].to_local().shape) == local
            np.testing.assert_array_equal(out["w"].full_tensor().numpy(),
                                          host["w"])
    """, world=4, tmp_path=tmp_path)


def test_elastic_controller_tracks_generations():
    ctl = ElasticController(model_parallel=1)
    devs = [torch.device("cpu")]
    ctl.form(devs)
    ctl.on_failure(devs)  # same devices, new generation
    assert ctl.generation == 2
    assert len(ctl.events) == 2


def test_elastic_controller_grows_and_shrinks_the_session():
    with PilotSession(**CPU) as s:
        s.add_pilot(memory_gb=0.05)
        ctl = ElasticController(1, session=s, min_pilots=1, max_pilots=3)
        grid = ctl.grow(2)
        assert len(s.pilots) == 3
        # the pilots share the one host device: deduped
        assert grid.shape == (1, 1) and grid.devices[0, 0] == torch.device(
            "cpu")
        ctl.shrink()
        assert len(s.pilots) == 2
        assert ctl.generation == 2
        actions = [d.action for d in ctl.autoscaler.decisions]
        assert actions == ["scale-out", "scale-out", "scale-in"]
        ctl.close()
    with pytest.raises(RuntimeError, match="session="):
        ElasticController(1).grow()


# -- no fallback hides the card ----------------------------------------------
@pytest.mark.parametrize("how", ["description", "session"])
def test_simulated_pilot_without_cuda_raises(how):
    if torch.cuda.is_available():
        pytest.skip("this box has a card: the default device resolves")
    be = SimulatedClusterBackend(substrate="slurm")
    with pytest.raises(RuntimeError, match="CUDA"):
        if how == "description":
            be.provision(PilotComputeDescription(backend="simulated"))
        else:
            with PilotSession() as s:
                s.add_pilot(backend="simulated")
    # asked for, the CPU is used, and only then
    p = be.provision(PilotComputeDescription(backend="simulated",
                                             startup_seconds=0.01, **CPU))
    try:
        assert p.devices == [torch.device("cpu")]
    finally:
        be.release(p)


# -- on the card -------------------------------------------------------------
@pytest.mark.gpu
def test_lose_memory_kill_frees_device_memory():
    """A kill with lose_memory drops every reference to the pilot's
    device-tier tensors: memory_allocated falls by the bytes it held."""
    _card()
    be = SimulatedClusterBackend(
        substrate="slurm", policy=ChaosPolicy(
            lose_memory=True, target_index=0,
            events=(ChaosEvent(at_s=3600.0, action="kill"),)))
    register_backend(be)
    try:
        with PilotSession() as s:
            victim = s.add_pilot(backend="simulated", startup_seconds=0.01,
                                 memory_gb=1)
            s.add_pilot(memory_gb=1)
            pts = np.random.default_rng(0).normal(
                size=(1 << 20, 8)).astype(np.float32)
            du = s.data("pts", pts, parts=8)
            s.data_service.replicate_to_pilot(du, victim.id, tier="device")
            held = victim.tier_manager.usage("device")
            assert held == pts.nbytes
            assert all(victim.tier_manager.backends["device"].get_device(
                du._key(i)).is_cuda for i in range(8))
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            victim.arm_chaos((ChaosEvent(at_s=0.0, action="kill"),))
            be.health(victim)                   # the probe fires the kill
            after = torch.cuda.memory_allocated()
            assert victim.state is State.FAILED
            assert victim.tier_manager.usage("device") == 0
            assert before - after >= held, (before, after, held)
    finally:
        register_backend(SimulatedClusterBackend())


@pytest.mark.gpu
def test_rebalancer_migration_between_cuda_pilots_keeps_bytes():
    _card()
    from repro_torch.core import InterconnectModel, Rebalancer
    with PilotSession(interconnect=InterconnectModel()) as s:
        donor, receiver = s.add_pilots(2, memory_gb=1)
        pts = np.random.default_rng(1).normal(size=(4096, 8)).astype(
            np.float32)
        du = s.data("pts", pts, parts=4)
        s.data_service.replicate_to_pilot(du, donor.id, tier="device")
        r = Rebalancer(s, skew=1.2, max_moves=2, tier="device")
        done = [m for m in r.rebalance_once() if m.status == "done"]
        assert done and all(m.cost_s > 0 for m in done)
        parts = np.array_split(pts, 4)
        for m in done:
            key = du._key(m.part)
            assert s.data_service.holders(key) == [receiver.id]
            t = receiver.tier_manager.backends["device"].get_device(key)
            assert t.is_cuda
            np.testing.assert_array_equal(t.cpu().numpy(), parts[m.part])
