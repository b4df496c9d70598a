"""The port's background mapping and abortable global BA on the CPU
(tpuslam_torch/pipeline/tracker.py with async_mapping), against the JAX
package's Tracker where the piece is deterministic.

- tests/test_async_mapping.py's stereo scenario (320x240, 500 features,
  30 keyframes, 8000 points, kf_max_frames 8, 20 frames) with mapping on
  the background thread, under its gates: OK, > 200 points, >= 18 frames
  tracked, rigid ATE < 0.06 m, the mapping future drained by the export.
  Adoption depends on thread timing, so the session is gated on quality.
- _poll_gba's merge of a finished global BA into a map that moved on (new
  keyframes and points after the snapshot), against the JAX tracker's on
  the same map and the same result, within 1e-5; a stale generation
  leaves the map unchanged.
- The async global BA on testing.build_loop_map's 16-keyframe map (points
  perturbed, as tests/test_async_mapping.py does): _schedule_gba returns
  at once and the merge halves the mean reprojection error; a superseded
  run leaves the map unchanged.
- NeedNewKeyFrame's full policy (idle or busy mapper, mono or depth, c1a /
  c1b / c1c, the relocalization gate, localization mode) against the JAX
  tracker's over a table of cases, InterruptBA included.
- With InterruptBA signalled during the first local-BA chunk,
  _mapping_compute equals a job that runs one chunk, to the bit.
- The BoW database read by snapshots while a thread adds rows (the
  mapping thread against relocalization): no snapshot holds a torn row.
"""

import concurrent.futures
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuslam.geometry.camera import PinholeCamera as JCamera
from tpuslam.mapstate import core as jcore
from tpuslam.pipeline.tracker import Tracker as JTracker, TrackerConfig as JTrackerConfig
from tpuslam_torch.convert import camera_from, map_to_numpy
from tpuslam_torch.geometry.camera import PinholeCamera, project
from tpuslam_torch.geometry.se3 import se3_apply, so3_exp
from tpuslam_torch.mapstate.core import update_point_normals
from tpuslam_torch.ops.orb import ORBConfig
from tpuslam_torch.pipeline import steps
from tpuslam_torch.pipeline.system import SensorType, System
from tpuslam_torch.pipeline.tracker import Tracker, TrackerConfig
from tpuslam_torch.testing import (
    LOOP_CAM,
    StepWallScene,
    build_loop_map,
    depth_session,
    keep_mapping_inputs,
    orbit_trajectory,
    render_stereo_frames,
    trajectory_ate,
)

torch.set_num_threads(2)

BASELINE_M = 0.12
CAM = PinholeCamera(fx=350.0, fy=350.0, cx=160.0, cy=120.0, bf=350.0 * BASELINE_M, width=320, height=240)
STEREO = dict(orb=ORBConfig(n_features=500), max_keyframes=30, max_points=8000, kf_max_frames=8)


@pytest.fixture(scope="module")
def async_run():
    """The async stereo session; the input of its first mapping job kept."""
    poses = orbit_trajectory(20, step=0.05)
    system = System(CAM, SensorType.STEREO, device="cpu", async_mapping=True, **STEREO)
    kept = keep_mapping_inputs(system.tracker, jobs={0})
    depth_session(system, render_stereo_frames(StepWallScene(np.random.default_rng(5)), CAM, poses))
    return system, poses, kept


def test_stereo_async_session_meets_the_sync_gates(async_run, tmp_path):
    system, poses, _ = async_run
    tr = system.tracker
    assert tr._mapping_pool is not None and tr.metrics.counters["frames.keyframe"] >= 1
    path = tmp_path / "kf.txt"
    system.save_keyframe_trajectory_tum(str(path))  # joins the job in flight first
    assert tr._mapping_future is None
    stats = system.map_stats()
    assert stats["state"] == "OK" and stats["n_points"] > 200
    assert len(path.read_text().splitlines()) == int(tr.map.kf_valid.sum())
    ate, n, _ = trajectory_ate(tr.export_trajectory(), poses, fix_scale=True)
    assert tr._mapping_future is None
    assert n >= 18 and ate < 0.06, (n, ate)
    system.shutdown()
    assert tr._mapping_pool is None and tr._gba_pool is None


def test_interrupted_job_runs_one_local_ba_chunk(async_run):
    """InterruptBA set while the first chunk runs: the second is skipped and
    the job equals mapping_front, one chunk and the normals."""
    m, ki = async_run[2][0]
    cfg = TrackerConfig(cam=CAM, enable_loop_closing=False, **STEREO)
    tr = Tracker(cfg, device="cpu")
    tr._depth_mode = True
    local_ba = tr._local_ba

    def first_chunk_then_interrupt(mm, center, iters=8):
        out = local_ba(mm, center, iters)
        tr._signal_mapping_interrupt()
        return out

    tr._local_ba = first_chunk_then_interrupt
    got = tr._mapping_compute(m, ki)
    assert tr.metrics.counters["map.local_ba2_skipped"] == 1
    ref = Tracker(cfg, device="cpu")
    want = steps.mapping_front(CAM, m, ki, ref.inv_sigma2, 2.0, scale_factor=cfg.orb.scale_factor,
                               n_levels=cfg.orb.n_levels, nn_tri=10, nn_fuse=10,
                               fuse_hop=cfg.fuse_second_hop, window=cfg.local_ba_window)
    want = update_point_normals(ref._local_ba(want, ki, iters=4), ref.scale_factors)
    for name, a, b in zip(got._fields, got, want):
        assert torch.equal(a, b), name


# ------------------------------------------------------------ global BA

def _perturbed_loop_map(seed=3):
    """build_loop_map without drift, the points comfortably in front of
    every camera that sees them moved by 2 cm (tests/test_async_mapping.py)."""
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
    return m._replace(pt_xyz=torch.where(safe[:, None], m.pt_xyz + noise, m.pt_xyz))


def _mean_reproj(m):
    err, n = 0.0, 0
    for k in range(int(m.n_kf)):
        obs = m.kf_obs_pt[k]
        has = obs >= 0
        uv = project(LOOP_CAM, se3_apply(m.kf_R[k], m.kf_t[k], m.pt_xyz[obs.clamp(min=0).long()]))
        err += float(torch.linalg.norm(uv - m.kf_kp_xy[k], dim=-1)[has].sum())
        n += int(has.sum())
    return err / max(n, 1)


def _gba_tracker():
    return Tracker(TrackerConfig(cam=LOOP_CAM, max_keyframes=24, max_points=2400, async_mapping=True,
                                 enable_loop_closing=False), device="cpu")


def test_async_global_ba_runs_in_the_background_and_merges():
    m = _perturbed_loop_map()
    tr = _gba_tracker()
    e0 = _mean_reproj(m)
    assert tr._schedule_gba(m, iters=10) is m  # returns at once
    assert tr._gba_future is not None
    tr._gba_future.result(timeout=300)
    m2 = tr._poll_gba(m)
    assert tr._gba_future is None
    e1 = _mean_reproj(m2)
    assert e1 < 0.5 * e0, (e0, e1)
    tr.shutdown()


def test_superseded_global_ba_leaves_the_map():
    m = _perturbed_loop_map()
    tr = _gba_tracker()
    tr._schedule_gba(m, iters=10)
    f = tr._gba_future
    tr._gba_generation += 1  # a newer closure supersedes the run
    res = f.result(timeout=300)
    m2 = tr._poll_gba(m)
    assert m2 is m
    assert res is None or res[3] != tr._gba_generation
    tr.shutdown()


def test_poll_gba_merge_equals_jax():
    """A global BA over the first 13 keyframes of the loop map finished
    while 3 more keyframes and their points were added: both trackers merge
    the same result into the same map."""
    rng = np.random.default_rng(7)
    m, _, _ = build_loop_map(rng, n_kf=16, drift=0.01)
    n_snap = 13
    fid_snap = m.kf_frame_id.clone()
    fid_snap[n_snap:] = 0
    valid_snap = m.kf_valid.clone()
    valid_snap[n_snap:] = False
    n_pt_snap = int((m.pt_first_kf[m.pt_valid] < n_snap).sum())
    K, P = m.capacity_kf, m.capacity_pt
    dR = so3_exp(torch.from_numpy(rng.normal(0, 0.01, (K, 3)).astype(np.float32)))
    R_g = dR @ m.kf_R
    t_g = m.kf_t + torch.from_numpy(rng.normal(0, 0.05, (K, 3)).astype(np.float32))
    X_g = m.pt_xyz + torch.from_numpy(rng.normal(0, 0.05, (P, 3)).astype(np.float32))

    def done(result):
        f = concurrent.futures.Future()
        f.set_result(result)
        return f

    kw = dict(max_keyframes=K, max_points=P, enable_loop_closing=False)
    tr = Tracker(TrackerConfig(cam=LOOP_CAM, **kw), device="cpu")
    jtr = JTracker(JTrackerConfig(cam=JCamera(**LOOP_CAM._asdict()), **kw))
    tr._gba_generation = jtr._gba_generation = 2
    tr._gba_future = done((R_g, t_g, X_g, 2, fid_snap, valid_snap, torch.tensor(n_pt_snap)))
    jtr._gba_future = done((jnp.asarray(R_g.numpy()), jnp.asarray(t_g.numpy()), jnp.asarray(X_g.numpy()), 2,
                            fid_snap.numpy(), valid_snap.numpy(), n_pt_snap))
    got = tr._poll_gba(m)
    want = jtr._poll_gba(jcore.MapState(*(jnp.asarray(a) for a in map_to_numpy(m))))
    for name in ("kf_R", "kf_t", "pt_xyz"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)), rtol=0,
                                   atol=1e-5, err_msg=name)
    # The snapshot keyframes took the result; the later ones moved with it.
    assert torch.equal(got.kf_R[:n_snap], R_g[:n_snap])
    assert not torch.allclose(got.kf_t[n_snap:16], m.kf_t[n_snap:16])
    assert torch.equal(got.pt_xyz[:n_pt_snap], X_g[:n_pt_snap])
    # A result of an older generation is dropped.
    tr._gba_future = done((R_g, t_g, X_g, 1, fid_snap, valid_snap, torch.tensor(n_pt_snap)))
    assert tr._poll_gba(m) is m and tr._gba_future is None


# ---------------------------------------------------------- NeedNewKeyFrame

def _future(state):
    if state is None:
        return None
    f = concurrent.futures.Future()
    if state == "done":
        f.set_result(None)
    return f


GATES = {  # [n_kf, ref_matches, close points tracked, close points untracked]
    "plain": [5, 200, 150, 10],
    "tiny_map_close_pressure": [1, 200, 50, 100],
    "big_map": [40, 200, 150, 10],
}


def test_need_new_keyframe_policy_equals_jax():
    kw = dict(max_keyframes=8, max_points=64, enable_loop_closing=False)
    tr = Tracker(TrackerConfig(cam=CAM, **kw), device="cpu")
    jtr = JTracker(JTrackerConfig(cam=JCamera(**CAM._asdict()), **kw))
    cases = itertools.product([None, "done", "busy"], [False, True], [0, 1, 5, 30], GATES,
                              [10, 45, 100, 170, 190], [-(10**9), 95], [False, True])
    seen = set()
    for mapper, depth, since, gates, n_tracked, reloc, loc in cases:
        got = []
        for t in (tr, jtr):
            t._mapping_future = _future(mapper)
            t._depth_mode, t._frames_since_kf, t._last_reloc_frame_id = depth, since, reloc
            t.localization_mode = loc
            t._mapping_interrupt.clear()
            ret = t._need_new_keyframe(n_tracked, 100, np.asarray(GATES[gates], np.float32))
            got.append((bool(ret), t._mapping_interrupt.is_set()))
        assert got[0] == got[1], (mapper, depth, since, gates, n_tracked, reloc, loc, got)
        seen.add(got[0])
    # Every outcome occurs: insert, not, and each with the interrupt signalled.
    assert seen == {(False, False), (True, False), (False, True), (True, True)}


def test_database_readers_see_whole_rows_while_a_thread_adds():
    """SparseKeyFrameDatabase under a writer thread (the mapping thread's
    adds) and a reader (relocalization's snapshot), the switch interval cut
    to provoke interleaving: every snapshot holds, for every slot it marks,
    the words and weights of one add."""
    import sys
    import threading

    from tpuslam_torch.place.database import SparseBow, SparseKeyFrameDatabase

    db = SparseKeyFrameDatabase(1000, 16, 8, device="cpu")
    stop, bad = threading.Event(), []

    def writer():
        for i in range(400):
            k = i % 16
            db.add(k, SparseBow(torch.full((8,), i, dtype=torch.int32), torch.full((8,), float(i))))
        stop.set()

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        th = threading.Thread(target=writer)
        th.start()
        while not stop.is_set():
            snap = db.snapshot()
            for k in torch.nonzero(snap.has)[:, 0].tolist():
                if not (torch.equal(snap.words[k], snap.words[k, :1].expand(8))
                        and torch.equal(snap.weight[k], snap.words[k].to(torch.float32))):
                    bad.append(k)
        th.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not th.is_alive() and not bad
    assert torch.equal(db.words[:, 0], torch.arange(384, 400, dtype=torch.int32))
