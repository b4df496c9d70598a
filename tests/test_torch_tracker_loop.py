"""The port's Tracker and System with loop closing on (the default) on the
CPU: the default configuration constructs and initializes, the monocular
scenario of tests/test_integration_mono.py (which runs with loop closing on)
passes that file's gates with the loop stage running on every keyframe job,
and the stereo session of tests/test_checkpoint_viz.py::TestBoWRelocalization
relocalizes through the BoW database's candidates.

The relocalization candidates are compared with the JAX package's
Tracker._reloc_candidate_kfs on the same state (the port's map, database
and frame carried across through numpy): the same keyframes, in order. The
relocalized camera centre must lie within 0.1 m of the truth.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuslam.mapstate.core import FrameFeatures as JFrameFeatures, MapState as JMapState
from tpuslam.pipeline.tracker import Tracker as JTracker
from tpuslam.place.database import SparseKeyFrameDatabase as JSparseKeyFrameDatabase
from tpuslam.place.vocabulary import Vocabulary as JVocabulary
from tpuslam_torch.convert import frame_features_to_numpy, map_to_numpy
from tpuslam_torch.geometry.camera import PinholeCamera
from tpuslam_torch.ops.orb import ORBConfig
from tpuslam_torch.pipeline.system import SensorType, System
from tpuslam_torch.pipeline.tracker import TrackerConfig, TrackingState
from tpuslam_torch.place.vocabulary import DEFAULT_VOCAB_PATH
from tpuslam_torch.testing import (
    StepWallScene,
    mono_session,
    orbit_trajectory,
    render_frames,
    render_stereo_frames,
    trajectory_ate,
)

torch.set_num_threads(2)

CAM = PinholeCamera(fx=350.0, fy=350.0, cx=160.0, cy=120.0, width=320, height=240)
BASELINE_M = 0.12
STEREO_CAM = CAM._replace(bf=350.0 * BASELINE_M)


def test_default_system_runs_with_loop_closing():
    """System(cam) with every default: loop closing on, nothing refused,
    and the session initializes on the CPU at the default capacities."""
    assert TrackerConfig(cam=CAM).enable_loop_closing
    system = System(CAM, device="cpu")
    tr = system.tracker
    assert tr.loop_closer is not None and tr.loop_closer.max_keyframes == 1536
    scene = StepWallScene(np.random.default_rng(11))
    frames = render_frames(scene, CAM, orbit_trajectory(3, step=0.045))
    outs = [system.track_monocular(f, i / 30.0) for i, f in enumerate(frames)]
    assert outs[-1] is not None and tr.state == TrackingState.OK


def test_mono_scenario_with_loop_closing_passes_the_integration_gates():
    scene = StepWallScene(np.random.default_rng(11))
    poses = orbit_trajectory(36, step=0.045)
    system = System(CAM, SensorType.MONOCULAR, orb=ORBConfig(n_features=800), device="cpu",
                    max_keyframes=40, max_points=6000, kf_max_frames=10)
    mono_session(system, render_frames(scene, CAM, poses))
    stats = system.map_stats()
    assert stats["state"] == "OK" and stats["n_keyframes"] >= 3 and stats["n_points"] > 150
    ate, n, _ = trajectory_ate(system.tracker.export_trajectory(), poses)
    assert n > 25 and ate < 0.03, (n, ate)
    tr = system.tracker
    lc = tr.loop_closer
    # The loop stage ran on every keyframe job, with the shipped vocabulary,
    # and the path revisits nothing.
    assert len(tr.metrics.timer.samples["map.loop"]) == tr.metrics.counters["frames.keyframe"] > 0
    assert lc.voc.n_words == 100_000 and lc.db is not None
    assert lc.n_loops_closed == 0


@pytest.fixture(scope="module")
def mapped_stereo():
    """tests/test_checkpoint_viz.py's mapped stereo run: 14 frames, 400
    features, 20 keyframes, 5000 points, kf_max_frames 6."""
    scene = StepWallScene(np.random.default_rng(5))
    poses = orbit_trajectory(14, step=0.05)
    frames = render_stereo_frames(scene, STEREO_CAM, poses)
    system = System(STEREO_CAM, SensorType.STEREO, orb=ORBConfig(n_features=400), device="cpu",
                    max_keyframes=20, max_points=5000, kf_max_frames=6)
    for i, (L, R) in enumerate(frames):
        system.track_stereo(L, R, i / 10.0)
    assert system.map_stats()["state"] == "OK"
    return system, frames, poses


def jax_reloc_candidates(tr, feats):
    """The JAX Tracker._reloc_candidate_kfs on the port's state."""
    db = tr.loop_closer.db
    jdb = JSparseKeyFrameDatabase(db.n_words, db.words.shape[0], db.words.shape[1])
    jdb.words, jdb.weight, jdb.has = (jnp.asarray(x.numpy()) for x in (db.words, db.weight, db.has))
    jlc = SimpleNamespace(voc=JVocabulary.load(DEFAULT_VOCAB_PATH), db=jdb)
    jm = JMapState(*map(jnp.asarray, map_to_numpy(tr.map)))
    jf = JFrameFeatures(*map(jnp.asarray, frame_features_to_numpy(feats)))
    return JTracker._reloc_candidate_kfs(SimpleNamespace(loop_closer=jlc, map=jm), jf)


def test_reloc_candidates_match_jax(mapped_stereo):
    system, frames, _ = mapped_stereo
    tr = system.tracker
    assert tr.loop_closer.voc is not None and tr.loop_closer.db is not None
    feats = tr._frame_features_stereo(*frames[9])
    cands = tr._reloc_candidate_kfs(feats)
    assert cands, "BoW query returned no relocalization candidates"
    assert cands == jax_reloc_candidates(tr, feats)


def test_reloc_via_bow_candidates(mapped_stereo):
    """Forced LOST, then frame 9 again: relocalized through the BoW
    candidates (not the brute-force match), within 0.1 m."""
    system, frames, poses = mapped_stereo
    tr = system.tracker
    tr.state = TrackingState.LOST
    r = system.track_stereo(*frames[9], 123.0)
    assert r is not None and tr.state == TrackingState.OK
    assert tr.reloc_path == "bow"
    R_est, t_est = r
    Rg, tg = np.asarray(poses[9][0]), np.asarray(poses[9][1])
    assert np.linalg.norm(-R_est.T @ t_est - (-Rg.T @ tg)) < 0.1


def test_reset_keeps_the_vocabulary(mapped_stereo):
    system, _, _ = mapped_stereo
    tr = system.tracker
    voc = tr.loop_closer.voc
    tr.reset()
    assert tr.loop_closer.voc is voc and tr.loop_closer.db is None
    assert tr.loop_closer.metrics is tr.metrics


def test_closure_remap_composes_with_a_pending_compaction(mapped_stereo):
    """A closure's point forwarding after a compaction of the same epoch:
    the tracker's pending remap becomes rl[r1] where r1 >= 0, else -1, as
    the JAX tracker composes them."""
    system, _, _ = mapped_stereo
    tr = system.tracker
    P = tr.map.capacity_pt
    rng = np.random.default_rng(3)
    r1 = np.where(rng.uniform(size=P) < 0.2, -1, rng.permutation(P)).astype(np.int32)
    rl = rng.permutation(P).astype(np.int32)

    class Closed:
        fix_scale = False
        stage_sync = False
        last_point_remap = torch.from_numpy(rl)

        def on_keyframe(self, m, cam, ki, ba_fn=None):
            return m, True

    saved = tr.loop_closer
    try:
        tr.loop_closer = Closed()
        tr._pending_pt_remap = torch.from_numpy(r1)
        tr._close_loops(tr.map, 0)
        want = np.where(r1 >= 0, rl[np.maximum(r1, 0)], -1)
        np.testing.assert_array_equal(tr._pending_pt_remap.numpy(), want)
        tr._pending_pt_remap = None
        tr._close_loops(tr.map, 0)
        np.testing.assert_array_equal(tr._pending_pt_remap.numpy(), rl)
    finally:
        tr.loop_closer = saved
        tr._pending_pt_remap = None
