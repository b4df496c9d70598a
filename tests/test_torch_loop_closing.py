"""The port's LoopCloser on the CPU: tests/test_loop_closing.py's five
scenarios on the port's own drifted loop map (testing.build_loop_map), the
essential graph through its CG branch, and the port against the JAX
LoopCloser on one map.

The comparison builds the map with the JAX test's build_loop_map and
carries it across (convert.map_to_torch); the port replays the JAX
closer's key chain (a split per RANSAC, then jax.random.randint) for its
Sim3 hypotheses. Tolerances: the same keyframe closes, with the same
candidate and loop edge; the corrected camera centres within 5 mm and the
rotations within 0.05 deg; the same count of valid points after fusion.
"""

import sys
from pathlib import Path

import jax
import numpy as np
import torch

from tpuslam_torch.convert import map_to_numpy, map_to_torch
from tpuslam_torch.mapstate.core import covisibility_weights
from tpuslam_torch.pipeline import loop_closing
from tpuslam_torch.pipeline.loop_closing import LoopCloser
from tpuslam_torch.testing import LOOP_CAM as CAM, build_loop_map

sys.path.insert(0, str(Path(__file__).parent))
from test_loop_closing import CAM as JCAM, build_loop_map as jbuild_loop_map  # noqa: E402

torch.set_num_threads(2)


def closer():
    return LoopCloser(max_keyframes=24, fix_scale=False, min_sim3_inliers=15)


def run(m, lc, n_kf):
    closed_at = None
    for k in range(n_kf):
        m, closed = lc.on_keyframe(m, CAM, k, ba_fn=None)
        if closed and closed_at is None:
            closed_at = k
    return m, closed_at


def centre(R, t):
    return -np.asarray(R).T @ np.asarray(t)


def drift_errors(m, gt, drifted):
    """The last keyframe's camera-centre error before and after."""
    C_gt = centre(*gt[-1])
    k = len(gt) - 1
    return (np.linalg.norm(centre(*drifted[-1]) - C_gt),
            np.linalg.norm(centre(m.kf_R[k].numpy(), m.kf_t[k].numpy()) - C_gt))


def test_detects_and_corrects_loop(rng):
    m, gt, drifted = build_loop_map(rng)
    lc = closer()
    m, closed_at = run(m, lc, len(gt))
    assert closed_at is not None, "loop never closed"
    assert lc.n_loops_closed >= 1
    before, after = drift_errors(m, gt, drifted)
    assert after < 0.5 * before, (before, after)


def test_no_false_loops_on_distinct_content(rng):
    m, gt, _ = build_loop_map(rng, drift=0.0, revisit=False)
    _, closed_at = run(m, closer(), len(gt))
    assert closed_at is None


def test_recycled_slot_invalidates_detection_state(rng):
    """A recycled slot's cached BoW and database row follow the new
    occupant, its sequence number is the newest, and a culled slot's row
    and cache are dropped."""
    m, gt, _ = build_loop_map(rng, drift=0.0, revisit=False)
    lc = closer()
    m, _ = run(m, lc, len(gt))
    assert 2 in lc._bow
    old_bow2 = lc._bow[2].densify(lc.voc.n_words).clone()
    seq_before = int(lc._slot_seq[2])

    new_desc = torch.from_numpy(rng.integers(0, 2**32, tuple(m.kf_kp_desc.shape[1:]), dtype=np.uint32)
                                .view(np.int32))
    fid = m.kf_frame_id.clone()
    fid[2] = 99
    desc = m.kf_kp_desc.clone()
    desc[2] = new_desc
    m = m._replace(kf_frame_id=fid, kf_kp_desc=desc)
    m, _ = lc.on_keyframe(m, CAM, 2, ba_fn=None)
    assert int(lc._slot_seq[2]) > seq_before
    assert int(lc._slot_seq[2]) == lc._seq
    assert not torch.allclose(lc._bow[2].densify(lc.voc.n_words), old_bow2)
    assert torch.equal(lc.db.words[2], lc._bow[2].words)
    assert torch.equal(lc.db.weight[2], lc._bow[2].weight)

    valid = m.kf_valid.clone()
    valid[3] = False
    lc._reconcile(m._replace(kf_valid=valid))
    assert not bool(lc.db.has[3])
    assert 3 not in lc._bow


def test_loop_fusion_merges_duplicates_and_links_covisibility(rng):
    m, gt, _ = build_loop_map(rng)
    n_kf = len(gt)
    covis_pre = covisibility_weights(m).numpy()
    assert covis_pre[n_kf - 1, 0] < 15 and covis_pre[n_kf - 1, 1] < 15
    n_valid_before = int(m.pt_valid.sum())
    lc = closer()
    m, closed_at = run(m, lc, n_kf)
    assert closed_at is not None
    assert int(m.pt_valid.sum()) < n_valid_before, "no duplicates merged"
    covis_post = covisibility_weights(m).numpy()
    assert covis_post[closed_at, 0] >= 15 or covis_post[closed_at, 1] >= 15, covis_post[closed_at, :4]
    assert len(lc._loop_edges) == 1
    # The fusion's MapPoint::Replace forwarding: merged-away slots point at
    # live winners.
    repl = lc.last_point_remap.numpy()
    merged = np.nonzero(~m.pt_valid.numpy())[0]
    redirected = repl[merged] != merged
    assert redirected.any()
    assert m.pt_valid.numpy()[repl[merged][redirected]].all()


def test_second_essential_graph_includes_first_loop_edge(rng):
    m, gt, _ = build_loop_map(rng)
    n_kf = len(gt)
    lc = closer()
    m, _ = run(m, lc, n_kf)
    assert lc._loop_edges, "first loop never closed"
    fid_l, fid_c = lc._loop_edges[0]
    fid = m.kf_frame_id.numpy()
    slot_l = int(np.nonzero(fid == fid_l)[0][0])
    slot_c = int(np.nonzero(fid == fid_c)[0][0])
    lc._correct(m, CAM, kf_cur=n_kf - 2, kf_loop=1, s21=torch.tensor(1.0), R21=torch.eye(3),
                t21=torch.zeros(3), covis=covisibility_weights(m))
    pairs = {(min(a, b), max(a, b)) for a, b in lc._last_edge_slots}
    assert (min(slot_l, slot_c), max(slot_l, slot_c)) in pairs, sorted(pairs)[:10]


def test_essential_graph_through_the_cg_branch(rng, monkeypatch):
    """With the dense bound below the live keyframe count the essential
    graph takes the block-Jacobi CG over every slot, as a long session's
    does: the loop still closes and the drift still halves."""
    monkeypatch.setattr(loop_closing, "DENSE_NODES", 8)
    m, gt, drifted = build_loop_map(rng)
    lc = closer()
    m, closed_at = run(m, lc, len(gt))
    assert closed_at is not None
    stats = lc.pose_graph_stats
    assert stats["n_live"] == 16 and len(stats["cg_iters"]) == 15
    before, after = drift_errors(m, gt, drifted)
    assert after < 0.5 * before, (before, after)


def replay_jax_keys(lc):
    """Draw the Sim3 hypotheses as the JAX closer does: split PRNGKey(42)
    once per RANSAC, then randint in [0, max(n_valid, 3))."""
    key = [jax.random.PRNGKey(42)]

    def draw(n_hyp, size, valid):
        key[0], k = jax.random.split(key[0])
        hi = max(int(valid.sum()), size)
        return torch.from_numpy(np.array(jax.random.randint(k, (n_hyp, size), 0, hi)))

    lc._draw_picks = draw


def test_closing_matches_the_jax_loop_closer():
    from tpuslam.pipeline.loop_closing import LoopCloser as JLoopCloser

    jm, gt, _ = jbuild_loop_map(np.random.default_rng(0))
    m = map_to_torch(jm, "cpu")
    jlc = JLoopCloser(max_keyframes=24, fix_scale=False, min_sim3_inliers=15)
    lc = closer()
    replay_jax_keys(lc)
    closed = []
    for k in range(len(gt)):
        jm, jc = jlc.on_keyframe(jm, JCAM, k, ba_fn=None)
        m, c = lc.on_keyframe(m, CAM, k, ba_fn=None)
        closed.append((jc, c))
    assert [c for c, _ in closed] == [c for _, c in closed]
    assert any(c for c, _ in closed)
    assert lc._loop_edges == jlc._loop_edges
    assert lc._last_edge_slots == jlc._last_edge_slots
    mn = map_to_numpy(m)
    jR, jt = np.asarray(jm.kf_R), np.asarray(jm.kf_t)
    for k in range(len(gt)):
        assert np.linalg.norm(centre(mn.kf_R[k], mn.kf_t[k]) - centre(jR[k], jt[k])) < 5e-3
        # The angle from the chord |Ra - Rb| = 2 sqrt(2) sin(theta / 2).
        chord = np.linalg.norm(jR[k].astype(np.float64) - mn.kf_R[k]) / (2 * np.sqrt(2))
        assert np.rad2deg(2 * np.arcsin(min(chord, 1.0))) < 0.05
    assert int(mn.pt_valid.sum()) == int(np.asarray(jm.pt_valid).sum())
    np.testing.assert_array_equal(mn.kf_obs_pt, np.asarray(jm.kf_obs_pt))
