"""The port's distributed bundle adjusters (tpuslam_torch/parallel/dist_ba.py)
on the CPU: 8 shards on the CPU repeated, against the JAX package's solvers
on its 8-device virtual mesh (tests/conftest.py) and against the port's
single-device solver, on tpuslam/testing.py's synthetic_ba_problem (K=6,
P=128, 64 observations per keyframe) crossed through convert.py.

Tolerances are tests/test_dist_ba.py's: R within 1e-4, t and X within 1e-3
(the same sums in another order). The edge routing is host numpy in both
packages and must be equal exactly; the sharded result must not depend on
the shards' thread timing (the barrier adds the partials in shard order).
"""

import random
import threading
import time

import jax
import numpy as np
import pytest
import torch

from tpuslam.parallel.dist_ba import (
    distributed_bundle_adjustment as jdistributed,
    make_mesh as jmake_mesh,
    point_sharded_bundle_adjustment as jpoint_sharded,
    route_edges_to_point_shards as jroute,
)
from tpuslam.testing import map_from_ba_problem as jmap_from_ba_problem
from tpuslam.testing import synthetic_ba_problem as jsynthetic_ba_problem
from tpuslam_torch.convert import ba_problem_to_torch, camera_from, map_to_torch
from tpuslam_torch.optim.ba import bundle_adjustment
from tpuslam_torch.parallel.dist_ba import (
    ShardReducer,
    distributed_bundle_adjustment,
    make_mesh,
    point_sharded_bundle_adjustment,
    route_edges_to_point_shards,
    run_shards,
)
from tpuslam_torch.pipeline.tracker import Tracker, TrackerConfig
from tpuslam_torch.testing import synthetic_ba_problem

torch.set_num_threads(2)

MESH = ["cpu"] * 8
KW = dict(iters=4, cg_iters=20)


def _problem(P=128, K=6):
    jcam, jprob = jsynthetic_ba_problem(np.random.default_rng(0), K=K, P=P, n_obs_per_kf=64)
    return jcam, jprob, camera_from(jcam), ba_problem_to_torch(jprob, "cpu")


def _close(got, want):
    for a, b, tol in zip(got[:3], want[:3], (1e-4, 1e-3, 1e-3)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=tol)


def _mean_chi2(valid, chi2):
    return float(np.asarray(chi2)[np.asarray(valid)].mean())


@pytest.fixture(scope="module")
def single():
    _, _, cam, prob = _problem()
    return bundle_adjustment(cam, prob, **KW)


def test_point_sharded_matches_jax_and_single(single):
    jcam, jprob, cam, prob = _problem()
    got = point_sharded_bundle_adjustment(cam, prob, MESH, **KW)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:8]), ("points",))
    _close(got, jpoint_sharded(jcam, jprob, mesh, **KW))
    _close(got, single)
    # chi2 comes back in the original edge order.
    np.testing.assert_allclose(got[3].numpy(), single[3].numpy(), atol=5e-2)


def test_observation_parallel_matches_jax_and_single(single):
    jcam, jprob, cam, prob = _problem()
    got = distributed_bundle_adjustment(cam, prob, MESH, **KW)
    _close(got, jdistributed(jcam, jprob, jmake_mesh(8), **KW))
    _close(got, single)
    # And it converges: the mean chi2 falls below 5% of the start's.
    c0 = bundle_adjustment(cam, prob, iters=0, cg_iters=1)[3]
    assert _mean_chi2(prob.valid, got[3]) < 0.05 * _mean_chi2(prob.valid, c0)


def test_edge_routing_equals_jax():
    _, jprob, _, prob = _problem()
    want, want_perm = jroute(jprob, 8)
    got, perm = route_edges_to_point_shards(prob, 8)
    np.testing.assert_array_equal(perm, want_perm)
    for name, a, b in zip(got._fields, got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    # Every routed edge's point lies in its shard's block.
    per, blk = got.kf.shape[0] // 8, prob.X.shape[0] // 8
    pt = got.pt.numpy()
    for s in range(8):
        assert np.all((pt[s * per:(s + 1) * per] >= s * blk) & (pt[s * per:(s + 1) * per] < (s + 1) * blk))


def test_sharded_result_does_not_depend_on_thread_timing(monkeypatch):
    """Shards that reach the barrier in a random order give the same bits."""
    _, _, cam, prob = _problem()
    want = point_sharded_bundle_adjustment(cam, prob, MESH[:4], iters=2, cg_iters=8)
    allreduce = ShardReducer.allreduce
    delays = random.Random(0)
    lock = threading.Lock()

    def late(self, shard, x):
        with lock:
            d = delays.random() * 2e-3
        time.sleep(d)
        return allreduce(self, shard, x)

    monkeypatch.setattr(ShardReducer, "allreduce", late)
    got = point_sharded_bundle_adjustment(cam, prob, MESH[:4], iters=2, cg_iters=8)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_reducer_under_more_shards_than_cores():
    """16 shards (more threads than cores) and a switch interval cut to
    provoke interleaving: every shard gets every round's exact sum."""
    import sys

    n, rounds = 16, 200
    red = ShardReducer(["cpu"] * n)

    def body(s):
        return [red.allreduce(s, torch.tensor([float(s * r + 1)], dtype=torch.float64)) for r in range(rounds)]

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        outs = run_shards(["cpu"] * n, body, red)
    finally:
        sys.setswitchinterval(interval)
    want = [float(sum(s * r + 1 for s in range(n))) for r in range(rounds)]
    assert all([float(x) for x in o] == want for o in outs)
    assert red.reductions == rounds


def test_a_failing_shard_fails_the_call():
    red = ShardReducer(["cpu"] * 3)

    def body(s):
        if s == 1:
            raise ValueError("shard 1 failed")
        return red.allreduce(s, torch.ones(2))

    with pytest.raises(ValueError, match="shard 1 failed"):
        run_shards(["cpu"] * 3, body, red)


def test_make_mesh():
    assert make_mesh(3, "cpu") == [torch.device("cpu")] * 3
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="visible"):
            make_mesh(2, "cuda")


class TestTrackerDistBA:
    """The tracker's global and local BA point-sharded (dist_ba_devices=8 on
    a CPU tracker: the CPU repeated) against the single-device paths."""

    def _tracker(self, cam, n):
        return Tracker(TrackerConfig(cam=cam, max_keyframes=8, max_points=128, enable_loop_closing=False,
                                     dist_ba_devices=n), device="cpu")

    def test_global_and_local_ba_distributed(self):
        jcam, jprob, cam, _ = _problem()
        m = map_to_torch(jmap_from_ba_problem(jcam, jprob, max_kf=8, n_kp=80, max_pt=128), "cpu")
        single, dist = self._tracker(cam, 0), self._tracker(cam, 8)
        assert dist._ba_mesh == [torch.device("cpu")] * 8
        g1, g2 = single._global_ba(m, iters=4), dist._global_ba(m, iters=4)
        np.testing.assert_allclose(g2.kf_R.numpy(), g1.kf_R.numpy(), atol=1e-4)
        np.testing.assert_allclose(g2.pt_xyz.numpy(), g1.pt_xyz.numpy(), atol=1e-3)
        l1, l2 = single._local_ba(g1, 5), dist._local_ba(g1, 5)
        np.testing.assert_allclose(l2.kf_R.numpy(), l1.kf_R.numpy(), atol=1e-4)
        # The same observations detached by the chi2 prune.
        np.testing.assert_array_equal(l2.kf_obs_pt.numpy() >= 0, l1.kf_obs_pt.numpy() >= 0)


class TestReducerPayload:
    """The point-sharded solver's reductions carry the pose system (O(K)
    bytes), not the point blocks (O(P)); tests/test_dist_ba.py's
    TestCollectivePayload for the port's reducer."""

    @staticmethod
    def _bytes(K, P):
        cam, prob = synthetic_ba_problem(np.random.default_rng(0), K=K, P=P, n_obs_per_kf=64)
        stats = {}
        point_sharded_bundle_adjustment(cam, prob, ["cpu"] * 4, iters=2, cg_iters=4, stats=stats)
        assert stats["bytes_per_iteration"] == stats["bytes"] / 2
        return stats["bytes"]

    def test_payload_is_O_K_not_O_P(self):
        b_p1, b_p4, b_k2 = self._bytes(6, 256), self._bytes(6, 1024), self._bytes(12, 256)
        assert b_p4 == b_p1
        assert b_p1 < b_k2 <= 2 * b_p1 + 64

    def test_observation_parallel_payload_carries_the_points(self):
        cam, prob = synthetic_ba_problem(np.random.default_rng(0), K=6, P=256, n_obs_per_kf=64)
        point, obs = {}, {}
        point_sharded_bundle_adjustment(cam, prob, ["cpu"] * 4, iters=2, cg_iters=4, stats=point)
        distributed_bundle_adjustment(cam, prob, ["cpu"] * 4, iters=2, cg_iters=4, stats=obs)
        # On top, per point and LM iteration: Hll with bl (12 floats), S v's
        # point sums (3 per CG iteration) and W^T dx (3).
        assert obs["bytes"] - point["bytes"] == 2 * 4 * 256 * (12 + 3 * 4 + 3)
