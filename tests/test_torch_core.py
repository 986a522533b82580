"""repro_torch.core against repro.core: the substrate of the KMeans path.

The device tier's mutation contract, LocalityPolicy scores (bit for bit
on the scenarios of test_scheduling.py), map_reduce on the host and
device tiers, the device rules of the entry points, the features left to
a later slice, and the port's independence from JAX at runtime.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core as ref_core  # noqa: E402
import repro_torch.core as port_core  # noqa: E402
from repro_torch.core.device import to_device  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"


def _dev_kw(pkg):
    """Keyword that puts the port's device tier on the CPU (none for JAX)."""
    return {"device": "cpu"} if pkg is port_core else {}


# -- the device tier's mutation contract -----------------------------------
def test_device_backend_put_copies_the_callers_array():
    be = port_core.make_backend("device", device="cpu")
    arr = np.arange(12, dtype=np.float32).reshape(3, 4)
    be.put("a", arr)
    arr[0, 0] = 99.0
    assert be.get("a")[0, 0] == 0.0
    assert float(be.get_device("a")[0, 0]) == 0.0


def test_device_backend_get_returns_read_only_views():
    be = port_core.make_backend("device", device="cpu")
    be.put("a", np.ones((4, 2), np.float32))
    view = be.get("a")
    assert not view.flags.writeable
    with pytest.raises(ValueError):
        view[0, 0] = 5.0
    assert float(be.get_device("a").sum()) == 8.0


def test_to_device_never_aliases_numpy():
    arr = np.zeros(4, np.float32)
    t = to_device(arr, "cpu")
    arr[0] = 1.0
    assert float(t[0]) == 0.0


# -- LocalityPolicy: the same scores, bit for bit ---------------------------
def _managed_du(pkg, name, device_budget, parts=4):
    tm = pkg.TierManager({"host": pkg.make_backend("host"),
                          "device": pkg.make_backend("device",
                                                     **_dev_kw(pkg))},
                         {"device": device_budget}, promote_threshold=0)
    arr = np.ones((parts * 256, 4), np.float32)
    return pkg.DataUnit.from_array(name, arr, parts, tm.backends,
                                   tier="device", tier_manager=tm)


def _home_du(pkg, name, parts=4, rows=64):
    arr = np.arange(parts * rows * 4, dtype=np.float32).reshape(-1, 4)
    return pkg.DataUnit.from_array(name, arr, parts,
                                   {"host": pkg.make_backend("host")},
                                   tier="host")


def _pds_pilot(pkg, svc, pds):
    pilot = svc.submit_pilot(pkg.PilotComputeDescription(
        backend="inprocess", **_dev_kw(pkg)))
    pilot.attach_tier_manager(pkg.TierManager(
        {"host": pkg.make_backend("host"),
         "device": pkg.make_backend("device", **_dev_kw(pkg))},
        {"device": None}, promote_threshold=0))
    pds.register_pilot(pilot)
    return pilot


def _scores(pkg, scenario):
    """The scores of test_scheduling.py's scenarios, built in `pkg`."""
    svc = pkg.PilotComputeService()
    pds = None
    try:
        policy = pkg.LocalityPolicy()
        pilot = svc.submit_pilot(pkg.PilotComputeDescription(
            backend="inprocess", affinity="x", **_dev_kw(pkg)))
        part_bytes = 256 * 4 * 4
        if scenario in ("full", "half", "hosted"):
            du = {"full": lambda: _managed_du(pkg, "full", None),
                  "half": lambda: _managed_du(pkg, "half", 2 * part_bytes),
                  "hosted": lambda: _home_du(pkg, "hosted")}[scenario]()
            desc = pkg.ComputeUnitDescription(fn=lambda: 0, input_data=(du,),
                                              affinity="x")
            return [policy.score(pilot, desc)]
        pds = pkg.PilotDataService()
        a, b = _pds_pilot(pkg, svc, pds), _pds_pilot(pkg, svc, pds)
        du = pds.register(_home_du(pkg, "rep", parts=4))
        du.replicate_to_pilot(a, parts=[0, 1, 2])
        du.replicate_to_pilot(b, parts=[3], tier="host")
        desc = pkg.ComputeUnitDescription(fn=lambda: 0, input_data=(du,))
        manager = pkg.ComputeDataManager(svc)
        return [policy.score(a, desc), policy.score(b, desc),
                manager.score(a, desc), manager.score(b, desc)]
    finally:
        if pds is not None:
            pds.close()
        svc.cancel_all()


@pytest.mark.parametrize("scenario", ["full", "half", "hosted", "replicas"])
def test_locality_scores_equal_the_reference_bit_for_bit(scenario):
    ours, theirs = _scores(port_core, scenario), _scores(ref_core, scenario)
    assert ours == theirs
    assert all(isinstance(s, float) for s in ours)


# -- map_reduce parity -------------------------------------------------------
def _sum_sq(pkg):
    if pkg is port_core:
        return lambda p: torch.sum(p.to(torch.float32) ** 2)
    return lambda p: jnp.sum(p.astype(jnp.float32) ** 2)


@pytest.mark.parametrize("tier", ["host", "device"])
@pytest.mark.parametrize("pipeline", [True, False])
def test_map_reduce_sum_matches_the_reference(tier, pipeline):
    arr = np.random.default_rng(4).standard_normal((1000, 8)).astype(
        np.float32)
    out = []
    for pkg in (ref_core, port_core):
        backends = {"host": pkg.make_backend("host"),
                    "device": pkg.make_backend("device", **_dev_kw(pkg))}
        du = pkg.DataUnit.from_array("mr", arr, 5, backends, tier=tier)
        total = pkg.map_reduce(du, _sum_sq(pkg), lambda a, b: a + b,
                               pipeline=pipeline)
        out.append(float(np.asarray(total)))
    np.testing.assert_allclose(out[1], out[0], rtol=1e-5)
    np.testing.assert_allclose(out[1], float((arr.astype(np.float64) ** 2)
                                             .sum()), rtol=1e-5)


# -- device rules of the entry points ---------------------------------------
@pytest.mark.parametrize("entry", ["session", "description", "backend"])
def test_default_device_raises_without_cuda(entry):
    if torch.cuda.is_available():
        pytest.skip("this box has a card: the default device resolves")
    build = {"session": lambda: port_core.PilotSession(),
             "description": lambda: port_core.PilotComputeDescription(),
             "backend": lambda: port_core.make_backend("device")}[entry]
    with pytest.raises(RuntimeError, match="CUDA"):
        build()


@pytest.mark.parametrize("ask", ["autoscale", "rebalance", "simulated"])
def test_slice_two_features_raise_not_implemented(ask):
    if ask == "simulated":
        with port_core.PilotSession(device="cpu") as s:
            with pytest.raises(NotImplementedError,
                               match="Resilience and elasticity"):
                s.add_pilot(backend="simulated")
        return
    with pytest.raises(NotImplementedError,
                       match="Resilience and elasticity"):
        port_core.PilotSession(device="cpu", **{ask: True})


def test_port_runs_kmeans_without_jax_or_the_reference():
    code = textwrap.dedent("""
        import sys
        import repro_torch.core as c
        pts, _ = c.make_blobs(400, 4, d=8, seed=0)
        with c.PilotSession(device="cpu") as s:
            s.add_pilots(2, memory_gb=0.01)
            du = s.data("points", pts, parts=4)
            res = s.kmeans(du, k=4, iters=2)
        assert len(res.sse_history) == 2, res.sse_history
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "repro" or m.startswith("repro."))
        assert not bad, bad
        print("ok")
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(SRC)})
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


# -- a fault of the reference's task engine, repaired in the port -----------
@pytest.mark.parametrize("rep", range(8))
def test_pool_drains_on_close_no_task_lost(rep):
    """close() is a drain barrier: every accepted task runs.  The
    reference (and the port before its repair) let the pilot's CU loop set
    DONE before its pool drained, and the drain then failed the backlog
    with "pilot ... is Done" in about half the runs; repeated so that the
    race cannot hide."""
    import threading
    before = {t.name for t in threading.enumerate()}
    done = []
    with port_core.PilotSession(device="cpu") as s:
        s.add_pilot(task_workers=2)
        batch = s.submit_tasks([lambda i=i: done.append(i) or i
                                for i in range(500)])
        # close() without waiting: the drain must finish the backlog
    assert batch.done
    assert sorted(t.result() for t in batch) == list(range(500))
    assert len(done) == 500
    leaked = [t for t in threading.enumerate()
              if "-taskw" in t.name and t.name not in before and t.is_alive()]
    assert not leaked
