"""The port's LocalMapping steps against the JAX package's on the CPU, one
function at a time and mapping_front whole, from the same state.

The state is a small session map built by the port's monocular System
(320x240, 500 features, 16 keyframes of 1000 keypoint slots, 4096 points):
the input of its last keyframe job, converted to JAX through numpy. The JAX
steps run op by op (jax.disable_jit), as under jit XLA:CPU fuses
multiply-adds. Integer outputs (observation tables, validity, parents,
slots, merge maps, masks) must be equal, but for one documented case:
MapPoint::PredictScale's ceil(log(r) / log(1.2)) sits exactly on an integer
for a point seen from the keyframe that created it, and torch's and XLA's
float32 log can differ in the last bit, so fusion's octave window can
differ there (test_fuse_pair_match_matches_jax checks that every
differing match is such a point). Points and poses agree within 1e-4
(triangulated points 1e-3 relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuslam.geometry.camera import PinholeCamera as JCamera
from tpuslam.mapstate import core as jcore
from tpuslam.pipeline import steps as jsteps
from tpuslam_torch.convert import frame_features_to_numpy, map_to_numpy, map_to_torch
from tpuslam_torch.geometry.camera import PinholeCamera
from tpuslam_torch.mapstate.core import make_empty_map
from tpuslam_torch.ops.orb import ORBConfig
from tpuslam_torch.pipeline import steps as tsteps
from tpuslam_torch.pipeline.system import System
from tpuslam_torch.testing import (
    StepWallScene,
    keep_mapping_inputs,
    mono_session,
    orbit_trajectory,
    render_frames,
)

torch.set_num_threads(2)

CAM = PinholeCamera(fx=350.0, fy=350.0, cx=160.0, cy=120.0, width=320, height=240)
JCAM = JCamera(**CAM._asdict())
N_FRAMES = 14
SF, NL = 1.2, 8


@pytest.fixture(scope="module")
def snap():
    """(system, the input map of the last keyframe job, its keyframe, the
    rendered frames)."""
    scene = StepWallScene(np.random.default_rng(11))
    poses = orbit_trajectory(N_FRAMES, step=0.045)
    system = System(CAM, orb=ORBConfig(n_features=500), device="cpu", max_keyframes=16,
                    max_points=4096, kf_max_frames=10, enable_loop_closing=False)
    kept = keep_mapping_inputs(system.tracker)
    frames = render_frames(scene, CAM, poses)
    mono_session(system, frames)
    m, ki = kept[max(kept)]
    assert ki >= 4 and int(m.kf_valid.sum()) >= 5
    return system, m, ki, frames


def jmap(m):
    return jcore.MapState(*(jnp.asarray(x) for x in map_to_numpy(m)))


def jfeats(f):
    return jcore.FrameFeatures(*(jnp.asarray(x) for x in frame_features_to_numpy(f)))


def inv_s2(system):
    return system.tracker.inv_sigma2


def assert_maps_match(got, ref, float_tol=1e-4):
    """Every integer and bool field equal; the float fields within float_tol."""
    ref = map_to_numpy(map_to_torch(ref, "cpu"))
    got = map_to_numpy(got)
    for name, a, b in zip(got._fields, got, ref):
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, rtol=float_tol, atol=float_tol, err_msg=name)


def neighbors(m, ki):
    return [int(k) for k in tsteps.best_covisible_ids(m, ki, 4) if k >= 0]


def test_session_map_has_a_mapping_history(snap):
    system, m, ki, _ = snap
    assert int(m.pt_valid.sum()) > 200
    assert ((m.pt_first_kf >= 2) & m.pt_valid).any()  # points that mapping_front made
    assert len(neighbors(m, ki)) >= 2


def test_best_covisible_ids_matches_jax(snap):
    _, m, ki, _ = snap
    for anchor in (ki, 0, 1):
        for n in (3, 8, 20):
            ref = np.asarray(jsteps.best_covisible_ids(jmap(m), jnp.int32(anchor), n))
            np.testing.assert_array_equal(tsteps.best_covisible_ids(m, anchor, n).numpy(), ref)


def test_triangulate_new_points_matches_jax(snap):
    """Each neighbour pair alone on the JAX side, all of them in one batch
    on the port's."""
    system, m, ki, _ = snap
    nbs = neighbors(m, ki)
    got = tsteps.triangulate_new_points(CAM, m, ki, torch.tensor(nbs), inv_s2(system),
                                        scale_factor=SF, n_levels=NL)
    n_good = 0
    for c, ko in enumerate(nbs):
        with jax.disable_jit():
            ref = jsteps.triangulate_new_points(JCAM, jmap(m), jnp.int32(ki), jnp.int32(ko),
                                                jnp.asarray(inv_s2(system).numpy()),
                                                scale_factor=SF, n_levels=NL)
        xyz, desc, nvec, mind, maxd, slot_new, slot_old, good = (np.asarray(x) for x in ref)
        g = got[7][c].numpy()
        np.testing.assert_array_equal(g, good)
        np.testing.assert_array_equal(got[6][c].numpy()[g], slot_old[g])
        np.testing.assert_array_equal(got[5].numpy(), slot_new)
        np.testing.assert_allclose(got[0][c].numpy()[g], xyz[g], rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(got[2][c].numpy()[g], nvec[g], atol=1e-4)
        np.testing.assert_allclose(got[4][c].numpy()[g], maxd[g], rtol=1e-3)
        n_good += int(g.sum())
    assert n_good > 0


def test_cull_map_points_matches_jax(snap):
    _, m, ki, _ = snap
    # Make the found/visible ratio bite on some points.
    rng = np.random.default_rng(0)
    m = m._replace(pt_visible=m.pt_visible + torch.from_numpy(rng.integers(0, 8, m.capacity_pt).astype(np.float32)))
    for min_obs in (2.0, 3.0):
        got = tsteps.cull_map_points(m, ki, min_obs)
        with jax.disable_jit():
            ref = jsteps.cull_map_points(jmap(m), jnp.int32(ki), jnp.float32(min_obs))
        assert_maps_match(got, ref)
        assert int(got.pt_valid.sum()) < int(m.pt_valid.sum())


def on_octave_edge(m, src, dst, slots):
    """Whether keyframe src's points at `slots`, seen from keyframe dst, sit
    on an edge of MapPoint::PredictScale: ceil(log(r) / log(1.2)) with r =
    max_dist / dist within float error of an integer, as for a point seen
    from the keyframe that created it (r = 1.2^k). There torch's and XLA's
    float32 log differ in the last bit, and so may the octave window."""
    p = m.kf_obs_pt[src][slots].long()
    C = -(m.kf_R[dst].T @ m.kf_t[dst])
    r = (m.pt_max_dist[p] / torch.linalg.norm(m.pt_xyz[p] - C, dim=-1)).double()
    k = torch.log(r) / np.log(SF)
    return (torch.abs(k - torch.round(k)) < 1e-5).numpy()


def test_fuse_pair_match_matches_jax(snap):
    """Equal, except where a point sits on an edge of the octave prediction
    (on_octave_edge): every differing match must, and they are few."""
    system, m, ki, _ = snap
    nbs = neighbors(m, ki)
    pairs = [(ki, k) for k in nbs] + [(k, ki) for k in nbs]
    P = m.capacity_pt
    has = (m.kf_obs_pt >= 0) & m.kf_kp_valid & m.kf_valid[:, None]
    cnt = torch.zeros(P + 1).index_add(0, torch.where(has, m.kf_obs_pt, P).reshape(-1).long(),
                                       torch.ones(has.numel()))[:P]
    src = torch.tensor([p[0] for p in pairs])
    dst = torch.tensor([p[1] for p in pairs])
    got = tsteps._fuse_pair_match(CAM, m, cnt, src, dst, inv_s2(system), scale_factor=SF, n_levels=NL)
    n_hits = n_diff = 0
    for q, (s, d) in enumerate(pairs):
        with jax.disable_jit():
            ref = jsteps._fuse_pair_match(JCAM, jmap(m), jnp.asarray(cnt.numpy()), jnp.int32(s),
                                          jnp.int32(d), jnp.asarray(inv_s2(system).numpy()),
                                          scale_factor=SF, n_levels=NL)
        tgt, add, merge, winner, loser = (np.asarray(x) for x in ref)
        g_tgt, g_add, g_merge, g_win, g_lose = (x[q].numpy() for x in got)
        live = add | merge | g_add | g_merge
        diff = ((g_add != add) | (g_merge != merge) | (live & (g_tgt != tgt))
                | (merge & ((g_win != winner) | (g_lose != loser))))
        assert on_octave_edge(m, s, d, np.nonzero(diff)[0]).all()
        n_diff += int(diff.sum())
        n_hits += int(live.sum())
    assert n_hits > 0 and n_diff <= 0.05 * n_hits


@pytest.mark.parametrize("max_edges", [0, 3000])
def test_local_bundle_adjustment_matches_jax(snap, max_edges):
    """The full edge set (max_edges=0) and the compacted block (3000 of the
    16000 slots, active-keyframe edges first)."""
    system, m, ki, _ = snap
    kw = dict(window=8, iters=4, n_levels=NL, max_edges=max_edges, active_max=6)
    got = tsteps.local_bundle_adjustment(CAM, m, ki, inv_s2(system), **kw)
    with jax.disable_jit():
        jprob = jsteps.build_local_ba_problem(jmap(m), jnp.int32(ki), 8, 0)
        ref = jsteps.local_bundle_adjustment(JCAM, jmap(m), jnp.int32(ki),
                                             jnp.asarray(inv_s2(system).numpy()), **kw)
    for a, b in zip(tsteps.build_local_ba_problem(m, ki, 8), jprob):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert_maps_match(got, ref, float_tol=2e-4)
    assert not torch.equal(got.kf_R, m.kf_R)


def test_cull_keyframes_matches_jax(snap):
    _, m, ki, _ = snap
    protect = torch.zeros(m.capacity_kf, dtype=torch.bool)
    protect[[0, 1, ki]] = True
    got, culled = tsteps.cull_keyframes(m, ki, protect)
    with jax.disable_jit():
        ref, jculled = jsteps.cull_keyframes(jmap(m), jnp.int32(ki), jnp.asarray(protect.numpy()))
    np.testing.assert_array_equal(culled.numpy(), np.asarray(jculled))
    assert_maps_match(got, ref)


def test_mapping_front_matches_jax(snap):
    """The whole epoch: triangulation, culling, fusion, descriptors, keyframe
    culling. Keyframe validity, parents and the new points equal; the
    observation table in >= 99% of its live entries, point validity in
    >= 99.5% (the octave edges of fusion)."""
    system, m, ki, _ = snap
    kw = dict(scale_factor=SF, n_levels=NL, nn_tri=20, nn_fuse=20, fuse_hop=5, window=8)
    got = tsteps.mapping_front(CAM, m, ki, inv_s2(system), 3.0, **kw)
    with jax.disable_jit():
        ref = jsteps.mapping_front(JCAM, jmap(m), jnp.int32(ki), jnp.asarray(inv_s2(system).numpy()),
                                   jnp.float32(3.0), **kw)
    ref = map_to_torch(ref, "cpu")
    for name in ("kf_valid", "kf_parent", "n_kf", "n_pt", "pt_first_kf", "pt_ref_kf"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), getattr(ref, name).numpy(), err_msg=name)
    # Fusion sees the octave edges of test_fuse_pair_match_matches_jax.
    live = (got.kf_obs_pt >= 0) | (ref.kf_obs_pt >= 0)
    assert float((got.kf_obs_pt == ref.kf_obs_pt)[live].float().mean()) >= 0.99
    assert float((got.pt_valid == ref.pt_valid).float().mean()) >= 0.995
    both = got.pt_valid & ref.pt_valid
    np.testing.assert_allclose(got.pt_xyz[both].numpy(), ref.pt_xyz[both].numpy(), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got.kf_rel_R.numpy(), ref.kf_rel_R.numpy(), atol=1e-5)
    assert int(got.n_pt) > int(m.n_pt)  # it triangulated


def test_reloc_search_by_projection_matches_jax(snap):
    """A starved assignment (the first 20 descriptor matches against the
    keyframe's points) widened by projection from the keyframe's pose."""
    system, m, ki, frames = snap
    tr = system.tracker
    fid = int(m.kf_frame_id[ki])
    feats = tr._frame_features(frames[fid])
    saved = tr.map
    tr.map = m
    pt_idx, ok = tr._match_frame_to_kf_points(feats, ki)
    tr.map = saved
    keep = torch.nonzero(ok & (pt_idx >= 0))[:20, 0]
    obs = torch.full_like(pt_idx, -1)
    obs[keep] = pt_idx[keep]
    R, t = m.kf_R[ki], m.kf_t[ki]
    for window, max_desc in ((10.0, 100), (3.0, 64)):
        new_obs, n_add = tsteps.reloc_search_by_projection(
            CAM, m, ki, R, t, feats, obs, scale_factor=SF, n_levels=NL, window=window,
            max_desc_dist=max_desc)
        with jax.disable_jit():
            jobs, jn = jsteps.reloc_search_by_projection(
                JCAM, jmap(m), jnp.int32(ki), jnp.asarray(R.numpy()), jnp.asarray(t.numpy()),
                jfeats(feats), jnp.asarray(obs.numpy()), scale_factor=SF, n_levels=NL,
                window=window, max_desc_dist=max_desc)
        np.testing.assert_array_equal(new_obs.numpy(), np.asarray(jobs))
        assert int(n_add) == int(jn) > 0


# The cases of tests/test_fuse_dedupe.py, the port against JAX.
DEDUPE_CASES = [
    ([5, 7, 9, 11, 13, 7, 2, 5, -1, 3, 13, 9], 64, 5),
    ([4, 4, 4, -1, -1, 4, 4, 4], 8, 4),
    ([0, 1, 2] + list(range(10, 19)), 32, 3),
]


@pytest.mark.parametrize("ext, K, nn_fuse", DEDUPE_CASES)
def test_dedupe_fuse_targets_matches_jax(ext, K, nn_fuse):
    ref = np.asarray(jsteps.dedupe_fuse_targets(jnp.asarray(ext, jnp.int32), K=K, nn_fuse=nn_fuse))
    got = tsteps.dedupe_fuse_targets(torch.tensor(ext), K, nn_fuse).numpy()
    np.testing.assert_array_equal(got, ref)
    assert list(got[:nn_fuse]) == [e for e in ext[:nn_fuse] if e >= 0][:nn_fuse] or K == 8


def _map_with_redundant_kf(rng):
    """tests/test_kf_culling.py's map: keyframes 0..3 all observe the same
    20 points; keyframe 2 is fully redundant."""
    m = make_empty_map(6, 32, 64, "cpu")
    n_pt = 20
    pt_xyz = m.pt_xyz.clone()
    pt_xyz[:n_pt] = torch.from_numpy(rng.uniform(-1, 1, (n_pt, 3)).astype(np.float32))
    obs = m.kf_obs_pt.clone()
    obs[:4, :n_pt] = torch.arange(n_pt, dtype=torch.int32)
    kp_valid = m.kf_kp_valid.clone()
    kp_valid[:4, :n_pt] = True
    kf_t = m.kf_t.clone()
    kf_t[:4] = torch.tensor([[0, 0, 0], [0.1, 0, 0], [0.2, 0, 0], [0.3, 0, 0]])
    return m._replace(pt_xyz=pt_xyz, pt_valid=torch.arange(64) < n_pt, n_pt=torch.tensor(n_pt, dtype=torch.int32),
                      n_kf=torch.tensor(4, dtype=torch.int32), kf_valid=torch.arange(6) < 4,
                      kf_kp_valid=kp_valid, kf_obs_pt=obs, kf_t=kf_t)


@pytest.mark.parametrize("protected", [[0, 1, 3], [0, 3], [3]])
def test_cull_keyframes_cases_match_jax(rng, protected):
    m = _map_with_redundant_kf(rng)
    protect = torch.zeros(6, dtype=torch.bool)
    protect[protected] = True
    got, culled = tsteps.cull_keyframes(m, 3, protect)
    ref, jculled = jsteps.cull_keyframes(jmap(m), jnp.int32(3), jnp.asarray(protect.numpy()))
    np.testing.assert_array_equal(culled.numpy(), np.asarray(jculled))
    assert_maps_match(got, ref)
    for k in np.nonzero(culled.numpy())[0]:
        p = int(got.kf_parent[k])
        R_rec = got.kf_rel_R[k] @ got.kf_R[p]
        t_rec = got.kf_rel_R[k] @ got.kf_t[p] + got.kf_rel_t[k]
        np.testing.assert_allclose(R_rec.numpy(), m.kf_R[k].numpy(), atol=1e-6)
        np.testing.assert_allclose(t_rec.numpy(), m.kf_t[k].numpy(), atol=1e-6)
    assert bool(culled[2])
