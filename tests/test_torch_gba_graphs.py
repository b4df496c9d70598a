"""The JAX package's last two eager programs through StepGraphs
(pipeline/graphs.py): the global BA's LM iterations (optim/ba.py's
lm_step, as Tracker._global_ba runs them over an edge list padded to a
bucket) and the essential graph's Gauss-Newton steps (optim/pose_graph.py's
gn_setup, the CG blocks and gn_update; gn_dense_step). On the CPU at small
capacities, on testing.build_loop_map's 16-keyframe drifted loop map,
testing.synthetic_ba_problem, test_torch_ba.py's problems and
testing.drifted_loop; and on a card.

- The StepGraphs route (static buffers on the CPU, graph replays on a card)
  equals the eager route (every segment through call_segment) bit for bit,
  and still matches the JAX package's function within the tolerances of
  test_torch_ba.py and test_torch_pose_graph.py (stated at each check).
- A padded problem equals the unpadded one bit for bit; two live edge
  counts in one bucket share the graph's key.
- Each new segment runs on meta tensors with no device->host read, no copy
  between the host and the device, and no input modified.
- The GBA thread's chunks run through Tracker.gba_graphs and equal the same
  chunks run eagerly on the calling thread.

This module imports no jax at its top (the JAX comparisons import it), so
its card test runs on a machine without it:
    python -m pytest --noconftest tests/test_torch_gba_graphs.py -m cuda
"""

import copy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tpuslam_torch.convert import map_to_numpy
from tpuslam_torch.geometry.se3 import se3_apply
from tpuslam_torch.optim import ba, pose_graph
from tpuslam_torch.optim.ba import BAProblem, bundle_adjustment
from tpuslam_torch.pipeline._index import edge_bucket, sum_plan
from tpuslam_torch.pipeline.graphs import StepGraphs, call_segment
from tpuslam_torch.pipeline.loop_closing import LoopCloser
from tpuslam_torch.pipeline.tracker import Tracker, TrackerConfig
from tpuslam_torch.testing import (
    LOOP_CAM,
    build_loop_map,
    drifted_loop,
    map_from_ba_problem,
    synthetic_ba_problem,
)

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_graph_paths import _equal, _runs_on_meta  # noqa: E402  (tree equality, the meta-tensor rules)

torch.set_num_threads(2)

KF, PT = 24, 2400  # the loop map's capacities (build_loop_map's defaults for 16 keyframes)
GBA_ITERS = 5


def _perturbed_loop_map(seed: int = 3, device="cpu"):
    """build_loop_map without drift, the points comfortably in front of
    every camera that sees them moved by 2 cm (test_torch_async_mapping.py's)."""
    rng = np.random.default_rng(seed)
    m, _, _ = build_loop_map(rng, drift=0.0)
    obs = m.kf_obs_pt.numpy()
    min_z = np.full(m.capacity_pt, np.inf, np.float32)
    for k in range(int(m.n_kf)):
        has = obs[k] >= 0
        Xc = se3_apply(m.kf_R[k], m.kf_t[k], m.pt_xyz[np.maximum(obs[k], 0)]).numpy()
        np.minimum.at(min_z, obs[k][has], Xc[has, 2])
    safe = torch.from_numpy(m.pt_valid.numpy() & (min_z > 1.0))
    noise = torch.from_numpy(rng.normal(0, 0.02, tuple(m.pt_xyz.shape)).astype(np.float32))
    m = m._replace(pt_xyz=torch.where(safe[:, None], m.pt_xyz + noise, m.pt_xyz))
    return type(m)(*(x.to(device) for x in m))


def _tracker(device="cpu", **cfg):
    cfg = dict(dict(cam=LOOP_CAM, max_keyframes=KF, max_points=PT, enable_loop_closing=False), **cfg)
    return Tracker(TrackerConfig(**cfg), device=device)


def _unpadded_global_ba(tr, m, iters):
    """The global BA as it was before its edges were padded: the live edges
    (torch.nonzero) straight into bundle_adjustment."""
    K, N = m.kf_obs_pt.shape
    kfi = torch.arange(K, dtype=torch.int32).repeat_interleave(N)
    pti = m.kf_obs_pt.reshape(-1)
    has = (pti >= 0) & m.kf_kp_valid.reshape(-1) & m.kf_valid[kfi.long()]
    live = torch.nonzero(has & m.pt_valid[pti.clamp(min=0).long()])[:, 0]
    uvr = torch.cat([m.kf_kp_xy.reshape(K * N, 2), m.kf_kp_uright.reshape(K * N, 1)], dim=-1)
    lvl = torch.clamp(m.kf_kp_level.reshape(-1), 0, tr.inv_sigma2.shape[0] - 1).long()
    prob = BAProblem(R=m.kf_R, t=m.kf_t, X=m.pt_xyz, kf=kfi[live], pt=pti[live], uvr=uvr[live],
                     inv_sigma2=tr.inv_sigma2[lvl[live]], valid=torch.ones(live.shape, dtype=torch.bool),
                     fixed_kf=~m.kf_valid | (torch.arange(K) == 0), fixed_pt=~m.pt_valid)
    R, t, X, _ = bundle_adjustment(tr.cfg.cam, prob, iters=iters)
    return R, t, X, live.shape[0]


def _pad_problem(prob: BAProblem, size: int) -> BAProblem:
    """prob's edges padded to `size` with edges parked out of range (kf = K,
    pt = P), as Tracker._global_ba pads them."""
    n = size - prob.kf.shape[0]
    K, P = prob.R.shape[0], prob.X.shape[0]

    def p(a, fill):
        return torch.cat([a, torch.full((n, *a.shape[1:]), fill, dtype=a.dtype)])

    return prob._replace(kf=p(prob.kf, K), pt=p(prob.pt, P), uvr=p(prob.uvr, 0.0),
                         inv_sigma2=p(prob.inv_sigma2, 0.0), valid=p(prob.valid, False))


def _map_fields(m):
    return (m.kf_R, m.kf_t, m.pt_xyz)


@pytest.fixture(scope="module")
def loop_map():
    return _perturbed_loop_map()


# ------------------------------------------------------ 1. the global BA

def test_global_ba_graphed_equals_eager_and_matches_jax(loop_map):
    """Tracker._global_ba through the tracking thread's StepGraphs (one
    "ba_lm" run per LM iteration) against every iteration eager, bit for
    bit, on the loop map and on test_torch_dist_ba.py's global-BA map
    (testing.map_from_ba_problem); on the latter against the JAX
    Tracker._global_ba (all K*N slots) within test_torch_ba.py's tolerances
    (poses 2e-4, points 2e-3). (Not on the loop map: some of its points lie
    within 4 cm of a camera's plane, where a 3x3 point block overflows and
    the adjugate inverse gives NaN, as the JAX function does op by op; under
    jax.jit XLA's arithmetic keeps it finite.)"""
    import jax.numpy as jnp

    from tpuslam.geometry.camera import PinholeCamera as JCamera
    from tpuslam.mapstate import core as jcore
    from tpuslam.pipeline.tracker import Tracker as JTracker, TrackerConfig as JConfig

    cam, prob = synthetic_ba_problem(np.random.default_rng(0), K=6, P=128, n_obs_per_kf=64)
    ba_map = map_from_ba_problem(cam, prob, max_kf=8, n_kp=80, max_pt=128)
    for m, cfg in ((loop_map, dict(cam=LOOP_CAM)), (ba_map, dict(cam=cam, max_keyframes=8, max_points=128))):
        graphed, eager = _tracker(**cfg), _tracker(**cfg)
        eager.graphs.run = call_segment
        names = []
        run = graphed.graphs.run
        graphed.graphs.run = lambda name, *a, **kw: names.append(name) or run(name, *a, **kw)
        g = graphed._global_ba(m, iters=GBA_ITERS)
        assert names == ["ba_lm"] * GBA_ITERS
        assert _equal(_map_fields(g), _map_fields(eager._global_ba(m, iters=GBA_ITERS)))
        assert graphed.stats["gba_iters"] == GBA_ITERS and graphed.graphs.runs == GBA_ITERS
        assert graphed.stats["gba_graph_replays"] == graphed.stats["gba_graph_captures"] == 0  # the CPU

    jtr = JTracker(JConfig(cam=JCamera(**cam._asdict()), max_keyframes=8, max_points=128,
                           enable_loop_closing=False))
    jm = jtr._global_ba(jcore.MapState(*(jnp.asarray(x) for x in map_to_numpy(ba_map))), iters=GBA_ITERS)
    v, pv = ba_map.kf_valid.numpy(), ba_map.pt_valid.numpy()
    np.testing.assert_allclose(g.kf_R.numpy()[v], np.asarray(jm.kf_R)[v], atol=2e-4)
    np.testing.assert_allclose(g.kf_t.numpy()[v], np.asarray(jm.kf_t)[v], atol=2e-4)
    np.testing.assert_allclose(g.pt_xyz.numpy()[pv], np.asarray(jm.pt_xyz)[pv], rtol=2e-3, atol=2e-3)
    assert not np.allclose(g.pt_xyz.numpy()[pv], ba_map.pt_xyz.numpy()[pv], atol=1e-3)  # it moved the points


@pytest.mark.parametrize("which", ["ba_map", "loop_map"])
def test_padded_global_ba_equals_unpadded_at_two_live_counts(which, loop_map):
    """Two maps whose live edge counts differ but share a bucket: each
    padded solve (_global_ba) equals the unpadded one (the live edges alone)
    bit for bit, and the second map's run makes no new static buffer (one
    key, one graph on a card). On the global-BA map of
    test_torch_dist_ba.py and on the loop map after one BA (its first
    chunk rejects every step; see the test above)."""
    if which == "ba_map":
        cam, prob = synthetic_ba_problem(np.random.default_rng(1), K=6, P=128, n_obs_per_kf=64)
        m1, cfg = map_from_ba_problem(cam, prob, max_kf=8, n_kp=80, max_pt=128), dict(
            cam=cam, max_keyframes=8, max_points=128)
    else:
        m1, cfg = _tracker()._global_ba(loop_map, iters=1), {}
    obs = m1.kf_obs_pt.clone()
    obs[3, :7] = -1  # seven observations fewer
    m2 = m1._replace(kf_obs_pt=obs)
    tr = _tracker(**cfg)
    counts = []
    for m in (m1, m2):
        R, t, X, n = _unpadded_global_ba(tr, m, GBA_ITERS)
        assert not torch.equal(X, m.pt_xyz)  # it moved the points
        counts.append(n)
        n_buffers = len(tr.graphs._buffers)
        got = tr._global_ba(m, iters=GBA_ITERS)
        assert _equal(_map_fields(got), (R, t, X))
        if m is m2:
            assert len(tr.graphs._buffers) == n_buffers
    assert counts[0] != counts[1] and edge_bucket(counts[0]) == edge_bucket(counts[1])


@pytest.mark.parametrize("stereo", [False, True])
def test_padded_bundle_adjustment_equals_unpadded(stereo):
    """test_torch_ba.py's problem (invalid edges, fixed points, octave
    weights, stereo edges in one case) padded to 4096 and to 8192 edges:
    R, t, X and the live edges' chi2 bit-equal to the unpadded solve."""
    from test_torch_ba import make_problem

    from tpuslam_torch.convert import ba_problem_to_torch

    _, cam, jprob, _ = make_problem(0, stereo)
    prob = ba_problem_to_torch(jprob, "cpu")
    E = prob.kf.shape[0]
    want = bundle_adjustment(cam, prob, iters=10)
    for size in (4096, 8192):
        R, t, X, chi2 = bundle_adjustment(cam, _pad_problem(prob, size), iters=10)
        assert _equal((R, t, X, chi2[:E]), want)


def test_lm_step_through_graphs_equals_eager_on_a_synthetic_problem():
    """bundle_adjustment's `run`: a CPU StepGraphs (static buffers) against
    call_segment, bit for bit, one "ba_lm" run per iteration."""
    cam, prob = synthetic_ba_problem(np.random.default_rng(2), K=8, P=300, n_obs_per_kf=37)
    graphs = StepGraphs("cpu")
    got = bundle_adjustment(cam, prob, iters=6, run=graphs.run)
    assert graphs.runs == 6
    assert _equal(got, bundle_adjustment(cam, prob, iters=6))


def test_lm_step_makes_no_host_read_or_copy(monkeypatch):
    cam, prob = synthetic_ba_problem(np.random.default_rng(0), K=6, P=128, n_obs_per_kf=64)
    prob = _pad_problem(prob, 512)
    _runs_on_meta(ba.lm_step, dict(cam=cam, use_huber=True, cg_iters=3), dict(
        prob=prob, plans=ba.ba_plans(prob), R=prob.R, t=prob.t, X=prob.X,
        lam=torch.full((), 1e-4)), monkeypatch)


# ------------------------------------------------ 2. the essential graph

def _pg_inputs(Kn: int, fix_scale: bool):
    s0, R0, t0, e = drifted_loop(Kn, loop_pairs=((None, 0), (Kn // 2, 0)))
    s0 = s0 * torch.linspace(1.0, 1.05, Kn) if not fix_scale else s0
    fixed = torch.zeros(Kn, dtype=torch.bool)
    fixed[0] = True
    valid = torch.ones(Kn, dtype=torch.bool)
    valid[3] = False
    return s0, R0, t0, valid, fixed, e


SEGMENTS = {"dense": {"pg_dense"}, "cg": {"pg_setup", "cg", "pg_update"}}


@pytest.mark.parametrize("fix_scale", [False, True])
@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_gn_steps_graphed_equal_eager_and_match_jax(solver, fix_scale, monkeypatch):
    """optimize_pose_graph through its own StepGraphs (run=None) against
    every segment eager, bit for bit with the same reads and CG
    iterations; against the JAX solver within test_matches_jax's
    tolerances (s, R 1e-3, t 1e-3 of its scale, the error history 1e-3
    relative)."""
    from tpuslam.optim.pose_graph import Sim3Edges as JSim3Edges
    from tpuslam.optim.pose_graph import optimize_pose_graph as joptimize
    import jax.numpy as jnp

    Kn, dense_max = 40, (192 if solver == "dense" else 4)
    s0, R0, t0, valid, fixed, e = _pg_inputs(Kn, fix_scale)
    names = []
    real_run = StepGraphs.run

    def counting(self, name, fn, static, **inputs):
        names.append(name)
        return real_run(self, name, fn, static, **inputs)

    monkeypatch.setattr(StepGraphs, "run", counting)
    st_g, st_e = {}, {}
    kw = dict(iters=8, fix_scale=fix_scale, dense_max_nodes=dense_max)
    graphed = pose_graph.optimize_pose_graph(s0, R0, t0, valid, fixed, e, stats=st_g, **kw)
    monkeypatch.undo()
    eager = pose_graph.optimize_pose_graph(s0, R0, t0, valid, fixed, e, stats=st_e, run=call_segment, **kw)
    assert set(names) == SEGMENTS[solver]
    assert _equal(graphed, eager)
    assert st_g.get("reads") == st_e.get("reads")
    assert [int(x) for x in st_g.get("cg_iters", [])] == [int(x) for x in st_e.get("cg_iters", [])]
    js, jR, jt, jerr = joptimize(*(jnp.asarray(x.numpy()) for x in (s0, R0, t0, valid, fixed)),
                                 JSim3Edges(*(jnp.asarray(x.numpy()) for x in e)), **kw)
    s, R, t, err = graphed
    tol = 1e-3
    scale = float(np.abs(np.asarray(jt)).max())
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=tol)
    np.testing.assert_allclose(R.numpy(), np.asarray(jR), atol=tol)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), atol=tol * scale)
    np.testing.assert_allclose(err.numpy(), np.asarray(jerr), rtol=tol, atol=tol * float(jerr[0]))


@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_padded_pose_graph_equals_unpadded(solver):
    """The caller's own padding (pad_edges to 1024 and 4096 edges) gives
    the bits of the solve at its smallest bucket (MIN_EDGES)."""
    s0, R0, t0, valid, fixed, e = _pg_inputs(40, False)
    kw = dict(iters=4, dense_max_nodes=192 if solver == "dense" else 4, run=call_segment)
    want = pose_graph.optimize_pose_graph(s0, R0, t0, valid, fixed, e, **kw)
    assert e.i.shape[0] < pose_graph.MIN_EDGES
    for size in (1024, 4096):
        got = pose_graph.optimize_pose_graph(s0, R0, t0, valid, fixed, pose_graph.pad_edges(e, 40, size), **kw)
        assert _equal(got, want)


def test_solve_ex_is_solve_on_the_cpu():
    """The dense GN step solves with solve_ex (no host check of its status,
    so a card captures it): on the CPU the bits of torch.linalg.solve."""
    g = torch.Generator().manual_seed(0)
    A = torch.randn(7 * 30, 7 * 30, generator=g)
    A = A @ A.T + torch.eye(7 * 30)
    b = torch.randn(7 * 30, generator=g)
    assert torch.equal(torch.linalg.solve_ex(A, b)[0], torch.linalg.solve(A, b))


def _gn_inputs(Kn: int, E: int):
    s0, R0, t0, valid, fixed, e = _pg_inputs(Kn, False)
    e = pose_graph.pad_edges(e, Kn, E)
    ei, ej = e.i.long(), e.j.long()
    plans = pose_graph._GNPlans(sum_plan(torch.cat([ei, ej]), Kn), sum_plan(
        torch.cat([ei * Kn + ei, ej * Kn + ej, ei * Kn + ej, ej * Kn + ei]), Kn * Kn))
    return dict(s=s0, R=R0, t=t0, edges=e, plans=plans, node_fixed=fixed, pin_node=fixed | ~valid)


@pytest.mark.parametrize("segment", ["gn_setup", "gn_update", "gn_dense_step"])
def test_gn_segment_makes_no_host_read_or_copy(segment, monkeypatch):
    Kn = 12
    inputs = _gn_inputs(Kn, 256)
    static = dict(fix_scale=True, lam=1e-6)
    if segment == "gn_update":
        inputs = dict(s=inputs["s"], R=inputs["R"], t=inputs["t"], dx=torch.zeros(Kn, 7),
                      pin7=torch.zeros(Kn, 7, dtype=torch.bool))
        static = {}
    _runs_on_meta(getattr(pose_graph, segment), static, inputs, monkeypatch)


# ---------------------------------------------------------- 3. a closure

def _closure_run(lc, tr, m, n_kf):
    """Keyframes 0..n_kf-1 through lc with tr's (synchronous) global BA;
    returns (the map, the keyframe that closed, the state before it)."""
    closed_at, snap = None, None
    for k in range(n_kf):
        before = (m, lc.to("cpu"))
        m, closed = lc.on_keyframe(m, LOOP_CAM, k, ba_fn=tr._schedule_gba)
        if closed and closed_at is None:
            closed_at, snap = k, before
    return m, closed_at, snap


def test_closure_through_the_closers_graphs_equals_eager():
    """A closure on the drifted loop map (the essential graph through the
    closer's StepGraphs, the global BA through the tracker's map_graphs)
    against the same closure with every segment eager: the corrected map
    and the point remap bit-equal. The closing keyframe again from its
    snapshot on a copy of the closer holding the same StepGraphs: the same
    bits, and no new key."""
    m0, gt, _ = build_loop_map(np.random.default_rng(0))
    runs = {}
    for way in ("graphed", "eager"):
        lc = LoopCloser(max_keyframes=KF, fix_scale=False, min_sim3_inliers=15)
        tr = _tracker()
        if way == "eager":
            lc.cg_run = tr.map_graphs.run = call_segment
        m, kc, snap = _closure_run(lc, tr, m0, len(gt))
        runs[way] = (m, kc, snap, lc, tr)
    (mg, kg, snap, lc, tr), (me, ke, _, lce, _) = runs["graphed"], runs["eager"]
    assert kg is not None and kg == ke
    assert _equal(tuple(mg), tuple(me)) and _equal(lc.last_point_remap, lce.last_point_remap)
    assert lc.graphs is not None and lc.graphs.runs > 0 and lce.graphs is None
    assert set(c[0] for c in lc.graphs._graphs) <= {"pg_dense", "pg_setup", "cg", "pg_update"}
    assert tr.stats["gba_iters"] == 10 and tr.map_graphs.runs == 10
    # Again from the snapshot, through the same StepGraphs: no new buffer.
    m_snap, lc_snap = snap
    lc2 = lc_snap.to("cpu")
    assert lc2.graphs is None  # a copy captures its own ...
    lc2.graphs = lc.graphs      # ... unless given one
    n_buffers, runs0 = len(lc.graphs._buffers), lc.graphs.runs
    m2, closed = lc2.on_keyframe(m_snap, LOOP_CAM, kg, ba_fn=tr._schedule_gba)
    assert closed and _equal(tuple(m2), tuple(mg))
    assert len(lc.graphs._buffers) == n_buffers and lc.graphs.runs > runs0


def test_copies_and_resets_release_the_graphs():
    tr = _tracker(enable_loop_closing=True)
    tr.loop_closer.graphs = StepGraphs("cpu")
    tr2 = copy.deepcopy(tr)
    assert tr2.gba_graphs is not tr.gba_graphs and tr2.gba_graphs.runs == 0
    assert tr2.loop_closer.graphs is None
    g = tr.gba_graphs
    tr.reset()
    assert tr.gba_graphs is not g and tr.loop_closer.graphs is None


# ------------------------------------------------------ 4. the GBA thread

def test_gba_thread_chunks_equal_the_synchronous_chunks(loop_map):
    """The async global BA (2 chunks of 5 LM iterations on the GBA thread,
    through Tracker.gba_graphs) against the same two chunks run eagerly on
    this thread: bit-equal poses and points."""
    m = loop_map
    tr = _tracker(async_mapping=True)
    try:
        assert tr._schedule_gba(m, iters=10) is m
        R, t, X, *_ = tr._gba_future.result(timeout=300)
    finally:
        tr.shutdown()
    assert tr.gba_graphs.runs == 10 and tr.graphs.runs == tr.map_graphs.runs == 0
    assert tr.stats["gba_iters"] == 10
    sync = _tracker()
    sync.graphs.run = call_segment
    mm = m
    for _ in range(2):
        mm = sync._global_ba(mm, iters=5)
    assert _equal((R, t, X), _map_fields(mm))


# ---------------------------------------------------------------- card

@pytest.mark.cuda
def test_global_ba_and_closure_graphed_equal_eager_on_card():
    """On the card: the initial-size global BA (20 LM iterations) graphed
    (one capture, then replays) equal to eager; a closure graphed equal to
    eager, and the closing keyframe again on the same graphs replays with
    no new capture."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    m = _perturbed_loop_map(device="cuda")
    graphed, eager = _tracker("cuda"), _tracker("cuda")
    eager.graphs.run = call_segment
    g = graphed._global_ba(m, iters=20)
    assert _equal(_map_fields(g), _map_fields(eager._global_ba(m, iters=20)))
    st = graphed.stats
    assert st["gba_iters"] == st["gba_graph_replays"] == 20 and st["gba_graph_captures"] == 1

    m0, gt, _ = build_loop_map(np.random.default_rng(0), device="cuda")
    runs = {}
    for way in ("graphed", "eager"):
        lc = LoopCloser(max_keyframes=KF, fix_scale=False, min_sim3_inliers=15)
        tr = _tracker("cuda")
        if way == "eager":
            lc.cg_run = tr.map_graphs.run = call_segment
        runs[way] = (*_closure_run(lc, tr, m0, len(gt)), lc, tr)
    (mg, kg, snap, lc, tr), (me, ke, *_) = runs["graphed"], runs["eager"]
    assert kg is not None and kg == ke and _equal(tuple(mg), tuple(me))
    assert tr.stats["gba_graph_replays"] == tr.stats["gba_iters"] == 10
    captures = lc.graphs.captures
    assert captures > 0 and lc.graphs.replays > captures
    m_snap, lc_snap = snap
    lc2 = lc_snap.to("cuda")
    lc2.graphs = lc.graphs
    m2, closed = lc2.on_keyframe(type(m_snap)(*(x.cuda() for x in m_snap)), LOOP_CAM, kg,
                                 ba_fn=tr._schedule_gba)
    assert closed and _equal(tuple(m2), tuple(mg)) and lc.graphs.captures == captures
