"""The slice as a whole: the paper's KMeans through repro_torch against repro.

The same blobs (numpy, from a seed) go through `repro.core.PilotSession`
and `repro_torch.core.PilotSession(device="cpu")`: two pilots, eight
partitions replicated half to each, three Lloyd iterations.  Same math,
different reduction order between XLA and PyTorch, so the SSE history is
held to rtol 1e-5 and the centroids to atol 1e-5.  Also the v1
device-tier path (`kmeans(du, pilot=...)`), `make_blobs` byte for byte,
and a DataUnit carried across through `repro_torch.carry`.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as ref_core  # noqa: E402
import repro_torch.core as port_core  # noqa: E402
from repro_torch.carry import data_unit_from_numpy  # noqa: E402

N, K, D, PARTS, ITERS = 2000, 8, 8, 8, 3


def _session(pkg):
    return (pkg.PilotSession(device="cpu") if pkg is port_core
            else pkg.PilotSession())


def _session_kmeans(pkg, pts, seed=0):
    with _session(pkg) as s:
        pilots = s.add_pilots(2, memory_gb=0.05)
        du = s.data("points", pts, parts=PARTS)
        du.replicate_to_pilot(pilots[0], parts=range(0, PARTS // 2))
        du.replicate_to_pilot(pilots[1], parts=range(PARTS // 2, PARTS))
        res = s.kmeans(du, k=K, iters=ITERS, seed=seed)
        residency = [du.replica_residency(p) for p in pilots]
    return res, residency


def _assert_same_run(ours, theirs):
    assert len(ours.sse_history) == len(theirs.sse_history) == ITERS
    np.testing.assert_allclose(ours.sse_history, theirs.sse_history,
                               rtol=1e-5)
    np.testing.assert_allclose(ours.centroids, theirs.centroids, atol=1e-5)
    assert ours.centroids.dtype == theirs.centroids.dtype == np.float32


@pytest.mark.parametrize("seed", [0, 1])
def test_session_kmeans_matches_the_reference(seed):
    pts, _ = ref_core.make_blobs(N, K, d=D, seed=0)
    ours, our_res = _session_kmeans(port_core, pts, seed)
    theirs, their_res = _session_kmeans(ref_core, pts, seed)
    _assert_same_run(ours, theirs)
    assert our_res == their_res


def _v1_device_kmeans(pkg, pts):
    svc = pkg.PilotComputeService()
    kw = {"device": "cpu"} if pkg is port_core else {}
    try:
        pilot = svc.submit_pilot(pkg.PilotComputeDescription(
            backend="inprocess", **kw))
        backends = {"host": pkg.make_backend("host"),
                    "device": pkg.make_backend("device", **kw)}
        du = pkg.DataUnit.from_array("points", pts, PARTS, backends,
                                     tier="device")
        return pkg.kmeans(du, k=K, iters=ITERS, pilot=pilot)
    finally:
        svc.cancel_all()


def test_v1_device_tier_kmeans_matches_the_reference():
    pts, _ = ref_core.make_blobs(N, K, d=D, seed=0)
    ours = _v1_device_kmeans(port_core, pts)
    theirs = _v1_device_kmeans(ref_core, pts)
    assert ours.tier == theirs.tier == "device"
    _assert_same_run(ours, theirs)


@pytest.mark.parametrize("n,k,d,seed", [(2000, 8, 8, 0), (1037, 50, 8, 3),
                                        (500, 5000, 4, 7)])
def test_make_blobs_is_byte_for_byte_the_reference(n, k, d, seed):
    ours = port_core.make_blobs(n, k, d=d, seed=seed)
    theirs = ref_core.make_blobs(n, k, d=d, seed=seed)
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("tier", ["host", "device"])
def test_carried_data_unit_gives_the_same_kmeans(tier):
    pts, _ = ref_core.make_blobs(N, K, d=D, seed=0)
    ref_du = ref_core.DataUnit.from_array(
        "points", pts, PARTS, {"host": ref_core.make_backend("host")},
        tier="host")
    parts = [ref_du.partition_copy(i) for i in range(ref_du.num_partitions)]
    du = data_unit_from_numpy(
        "points", parts,
        {"host": port_core.make_backend("host"),
         "device": port_core.make_backend("device", device="cpu")}, tier)
    assert du.num_partitions == PARTS and du.tier == tier
    parts[0][0, 0] = 1e6            # the carried DU owns its bytes
    ours = port_core.kmeans(du, k=K, iters=ITERS)
    theirs = ref_core.kmeans(ref_du, k=K, iters=ITERS)
    _assert_same_run(ours, theirs)
