"""The port's Sim3 pose-graph optimizer against the JAX package's on the
CPU, then the port's copies of tests/test_place_posegraph.py's TestPoseGraph
and TestPoseGraphCG.

Tolerances: the dense solve's poses within 1e-4 of JAX's (t relative to
its scale, s and R absolute) and the CG solve's within 1e-3; the error
histories 1e-4 and 1e-3 relative. The CG runs as jax.scipy's cg does (the
same stopping rule), so the two packages take the same iterations but for
the rounding of the dot products.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuslam.optim.pose_graph import Sim3Edges as JSim3Edges
from tpuslam.optim.pose_graph import optimize_pose_graph as joptimize
from tpuslam_torch.geometry.se3 import so3_exp
from tpuslam_torch.geometry.sim3 import sim3_compose
from tpuslam_torch.optim.pose_graph import Sim3Edges, make_relative, optimize_pose_graph

torch.set_num_threads(2)


def _compose_chain(rels):
    """Absolute poses from relative steps: S_kw = rel_{k-1} * S_{k-1,w}."""
    s, R, t = [torch.tensor(1.0)], [torch.eye(3)], [torch.zeros(3)]
    for sr, Rr, tr in rels:
        sn, Rn, tn = sim3_compose(sr, Rr, tr, s[-1], R[-1], t[-1])
        s.append(sn)
        R.append(Rn)
        t.append(tn)
    return torch.stack(s), torch.stack(R), torch.stack(t)


def _edges(ei, ej, rel):
    ms, mR, mt = (torch.stack(x) for x in zip(*rel))
    n = len(ei)
    return Sim3Edges(i=torch.tensor(ei, dtype=torch.int32), j=torch.tensor(ej, dtype=torch.int32),
                     meas_s=ms, meas_R=mR, meas_t=mt, valid=torch.ones(n, dtype=torch.bool),
                     weight=torch.ones(n))


def drifted_loop(K, loop_pairs=((None, 0),), bias=(0.002, 0.005, -0.002), step=(0.51, 0.005, -0.005)):
    """A loop of K nodes: drifted odometry edges consistent with the initial
    poses plus loop edges with the true relative poses."""
    w = np.array([0.0, 2 * np.pi / (K - 1), 0.0], np.float32)
    rel_gt = [(torch.tensor(1.0), so3_exp(torch.from_numpy(w)), torch.tensor([0.5, 0.0, 0.0]))] * (K - 1)
    wn = (w + np.array(bias, np.float32)).astype(np.float32)
    rel_n = [(torch.tensor(1.0), so3_exp(torch.from_numpy(wn)), torch.tensor(step, dtype=torch.float32))] * (K - 1)
    s_gt, R_gt, t_gt = _compose_chain(rel_gt)
    s0, R0, t0 = _compose_chain(rel_n)
    ei, ej, rel = [], [], []
    for k in range(K - 1):
        ei.append(k)
        ej.append(k + 1)
        rel.append(make_relative(s0[k], R0[k], t0[k], s0[k + 1], R0[k + 1], t0[k + 1]))
    for a, b in loop_pairs:
        a = K - 1 if a is None else a
        ei.append(a)
        ej.append(b)
        rel.append(make_relative(s_gt[a], R_gt[a], t_gt[a], s_gt[b], R_gt[b], t_gt[b]))
    return s0, R0, t0, _edges(ei, ej, rel)


def to_jax(*xs):
    return [jnp.asarray(x.numpy()) for x in xs]


@pytest.mark.parametrize("solver, K, fix_scale", [
    ("dense", 24, False), ("dense", 24, True), ("cg", 40, False), ("cg", 40, True)])
def test_matches_jax(solver, K, fix_scale):
    s0, R0, t0, e = drifted_loop(K, loop_pairs=((None, 0), (K // 2, 0)))
    s0 = s0 * torch.linspace(1.0, 1.05, K) if not fix_scale else s0
    fixed = torch.zeros(K, dtype=torch.bool)
    fixed[0] = True
    valid = torch.ones(K, dtype=torch.bool)
    valid[3] = False  # a pinned, culled node
    dmax = 1024 if solver == "dense" else 4
    js, jR, jt, jerr = joptimize(*to_jax(s0, R0, t0, valid, fixed), JSim3Edges(*to_jax(*e)), iters=8,
                                 fix_scale=fix_scale, dense_max_nodes=dmax)
    stats = {}
    s, R, t, err = optimize_pose_graph(s0, R0, t0, valid, fixed, e, iters=8, fix_scale=fix_scale,
                                       dense_max_nodes=dmax, stats=stats)
    tol = 1e-4 if solver == "dense" else 1e-3
    scale = float(np.abs(np.asarray(jt)).max())
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=tol)
    np.testing.assert_allclose(R.numpy(), np.asarray(jR), atol=tol)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), atol=tol * scale)
    np.testing.assert_allclose(err.numpy(), np.asarray(jerr), rtol=tol, atol=tol * float(jerr[0]))
    assert float(err[-1]) < 0.1 * float(err[0])
    if solver == "cg":
        assert len(stats["cg_iters"]) == 8 and 0 < int(stats["cg_iters"][0]) <= 150


# -- The port's copies of tests/test_place_posegraph.py's pose-graph tests. --


class TestPoseGraph:
    def test_loop_drift_correction(self):
        K = 12
        w = np.array([0.0, 2 * np.pi / (K - 1), 0.0], np.float32)
        rels_gt = [(torch.tensor(1.0), so3_exp(torch.from_numpy(w)), torch.tensor([0.5, 0.0, 0.0]))] * (K - 1)
        s_gt, R_gt, t_gt = _compose_chain(rels_gt)
        wn = np.array([0.004, 2 * np.pi / (K - 1) + 0.01, -0.003], np.float32)
        rels_n = [(torch.tensor(1.0), so3_exp(torch.from_numpy(wn)), torch.tensor([0.52, 0.01, -0.01]))] * (K - 1)
        s0, R0, t0 = _compose_chain(rels_n)
        ei, ej, rel = [], [], []
        for k in range(K - 1):
            ei.append(k)
            ej.append(k + 1)
            rel.append(make_relative(s0[k], R0[k], t0[k], s0[k + 1], R0[k + 1], t0[k + 1]))
        sr, Rr, tr = make_relative(s_gt[K - 1], R_gt[K - 1], t_gt[K - 1], s_gt[0], R_gt[0], t_gt[0])
        ei.append(K - 1)
        ej.append(0)
        rel.append((sr, Rr, tr))
        fixed = torch.zeros(K, dtype=torch.bool)
        fixed[0] = True
        s, R, t, errs = optimize_pose_graph(s0, R0, t0, torch.ones(K, dtype=torch.bool), fixed,
                                            _edges(ei, ej, rel), iters=30)
        assert float(errs[-1]) < 0.1 * float(errs[0]), (float(errs[0]), float(errs[-1]))
        _, _, tl = sim3_compose(sr, Rr, tr, s[K - 1], R[K - 1], t[K - 1])
        gap_before = np.linalg.norm(sim3_compose(sr, Rr, tr, s0[K - 1], R0[K - 1], t0[K - 1])[2] - t0[0])
        gap_after = np.linalg.norm(tl - t[0])
        assert gap_after < 0.25 * gap_before, (gap_before, gap_after)

    def test_fixed_nodes_unmoved(self, rng):
        K = 5
        t0 = torch.from_numpy(rng.normal(size=(K, 3)).astype(np.float32))
        e = Sim3Edges(i=torch.arange(K - 1, dtype=torch.int32), j=torch.arange(1, K, dtype=torch.int32),
                      meas_s=torch.ones(K - 1), meas_R=torch.eye(3).repeat(K - 1, 1, 1),
                      meas_t=torch.from_numpy(rng.normal(size=(K - 1, 3)).astype(np.float32)),
                      valid=torch.ones(K - 1, dtype=torch.bool), weight=torch.ones(K - 1))
        fixed = torch.zeros(K, dtype=torch.bool)
        fixed[0] = True
        s, R, t, _ = optimize_pose_graph(torch.ones(K), torch.eye(3).repeat(K, 1, 1), t0,
                                         torch.ones(K, dtype=torch.bool), fixed, e, iters=10)
        np.testing.assert_allclose(t[0].numpy(), t0[0].numpy(), atol=1e-6)
        np.testing.assert_allclose(float(s[0]), 1.0, atol=1e-6)

    def test_fix_scale(self, rng):
        K = 4
        s0 = torch.tensor([1.0, 1.1, 0.9, 1.05])
        e = Sim3Edges(i=torch.arange(K - 1, dtype=torch.int32), j=torch.arange(1, K, dtype=torch.int32),
                      meas_s=torch.ones(K - 1), meas_R=torch.eye(3).repeat(K - 1, 1, 1),
                      meas_t=torch.zeros((K - 1, 3)), valid=torch.ones(K - 1, dtype=torch.bool),
                      weight=torch.ones(K - 1))
        fixed = torch.zeros(K, dtype=torch.bool)
        fixed[0] = True
        s, R, t, _ = optimize_pose_graph(
            s0, torch.eye(3).repeat(K, 1, 1), torch.from_numpy(rng.normal(size=(K, 3)).astype(np.float32)),
            torch.ones(K, dtype=torch.bool), fixed, e, iters=10, fix_scale=True)
        np.testing.assert_allclose(s.numpy(), s0.numpy(), atol=1e-5)


class TestPoseGraphCG:
    def test_cg_matches_dense(self):
        K = 24
        s0, R0, t0, e = drifted_loop(K)
        fixed = torch.zeros(K, dtype=torch.bool)
        fixed[0] = True
        valid = torch.ones(K, dtype=torch.bool)
        sd, Rd, td, ed = optimize_pose_graph(s0, R0, t0, valid, fixed, e, iters=10, dense_max_nodes=1024)
        sc, Rc, tc, ec = optimize_pose_graph(s0, R0, t0, valid, fixed, e, iters=10, dense_max_nodes=4)
        np.testing.assert_allclose(td.numpy(), tc.numpy(), atol=2e-3)
        np.testing.assert_allclose(sd.numpy(), sc.numpy(), atol=1e-4)
        assert abs(float(ed[-1]) - float(ec[-1])) < 1e-3 * max(float(ed[0]), 1.0)

    def test_cg_matches_dense_fix_scale(self):
        K = 24
        s0, R0, t0, e = drifted_loop(K)
        fixed = torch.zeros(K, dtype=torch.bool)
        fixed[0] = True
        valid = torch.ones(K, dtype=torch.bool)
        sd, _, td, _ = optimize_pose_graph(s0, R0, t0, valid, fixed, e, iters=10, fix_scale=True,
                                           dense_max_nodes=1024)
        sc, _, tc, _ = optimize_pose_graph(s0, R0, t0, valid, fixed, e, iters=10, fix_scale=True,
                                           dense_max_nodes=4)
        np.testing.assert_allclose(sd.numpy(), np.ones(K), atol=1e-6)
        np.testing.assert_allclose(sc.numpy(), np.ones(K), atol=1e-6)
        np.testing.assert_allclose(td.numpy(), tc.numpy(), atol=2e-3)

    def test_large_graph_converges(self):
        """A KITTI-00-scale node count through the CG path only."""
        K = 700
        s0, R0, t0, e = drifted_loop(K, loop_pairs=((None, 0), (350, 0)))
        fixed = torch.zeros(K, dtype=torch.bool)
        fixed[0] = True
        s, R, t, errs = optimize_pose_graph(s0, R0, t0, torch.ones(K, dtype=torch.bool), fixed, e, iters=8)
        assert torch.isfinite(t).all()
        assert float(errs[-1]) < 0.1 * float(errs[0]), (float(errs[0]), float(errs[-1]))
