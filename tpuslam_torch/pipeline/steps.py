"""Tracking step functions over (MapState, frame tensors). Port of the
tracking half of tpuslam/pipeline/steps.py.

Each function returns what its JAX counterpart returns, in the same order.
The JAX package compiles the fused step into one program whose data-
dependent branches are lax.cond; PyTorch runs eagerly, so those branches
are host branches here. `has_vel` is a host bool, as the tracker holds it;
the th=14 retry and the motion-model verdict each cost one device->host
read (`_fused_track_core`). Everything else stays on the device.

Scatters follow the JAX package's rules (pipeline/_index.py): the last of
repeated writes wins, out-of-bounds writes are dropped, and the fixed-size
nonzero lists are built without a sync.
"""

from __future__ import annotations

import torch

from tpuslam_torch.geometry.camera import PinholeCamera, project, undistort_points
from tpuslam_torch.geometry.se3 import se3_apply, se3_compose, se3_inverse
from tpuslam_torch.mapstate.core import FrameFeatures, MapState, shared_point_counts
from tpuslam_torch.matching.search import (
    TH_HIGH,
    TH_LOW,
    match_nn_ratio,
    resolve_duplicates,
    rotation_consistency_mask,
    search_by_projection_points,
)
from tpuslam_torch.optim.pose import PoseObs, pose_optimization
from tpuslam_torch.pipeline._index import (
    nonzero_static,
    scatter_last,
    scatter_last_dropping,
    sf_pow,
)


def predict_scale(dist: torch.Tensor, max_dist: torch.Tensor, scale_factor: float, n_levels: int):
    """MapPoint::PredictScale: octave at which the point would be detected
    at this viewing distance. log(scale_factor) is taken in float32, as the
    JAX package does."""
    ratio = torch.clamp(max_dist / torch.clamp(dist, min=1e-9), min=1e-9)
    log_sf = torch.log(torch.full((), scale_factor, dtype=torch.float32, device=dist.device))
    lvl = torch.ceil(torch.log(ratio) / log_sf).to(torch.int32)
    return torch.clamp(lvl, 0, n_levels - 1)


def _in_image(cam: PinholeCamera, uv: torch.Tensor) -> torch.Tensor:
    return ((uv[..., 0] >= 0) & (uv[..., 0] < cam.width)
            & (uv[..., 1] >= 0) & (uv[..., 1] < cam.height))


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[max(idx, 0)]: the JAX package's clamped gather of -1 entries."""
    return x[idx.clamp(min=0).long()]


def track_motion_model(cam: PinholeCamera, m: MapState, last_feats: FrameFeatures,
                       last_obs_pt, R_pred, t_pred, cur: FrameFeatures, inv_sigma2_table,
                       scale_factor: float = 1.2, n_levels: int = 8, th: float = 7.0):
    """TrackWithMotionModel: project the last frame's map points with the
    predicted pose, match in a window, then pose-optimize. Returns
    (R, t, obs_pt (N,), n_map_inliers, n_matches)."""
    pt_idx = last_obs_pt
    has_pt = (pt_idx >= 0) & last_feats.valid & _take(m.pt_valid, pt_idx)
    R, t, obs_pt2, _, n_map, _, n_matches = track_motion_model_pts(
        cam, last_feats, _take(m.pt_xyz, pt_idx), pt_idx, has_pt, R_pred, t_pred, cur,
        inv_sigma2_table, scale_factor=scale_factor, n_levels=n_levels, th=th,
    )
    return R, t, obs_pt2, n_map, n_matches


def track_motion_model_pts(cam: PinholeCamera, last_feats: FrameFeatures, last_xyz,
                           last_tag, last_has, R_pred, t_pred, cur: FrameFeatures,
                           inv_sigma2_table, scale_factor: float = 1.2, n_levels: int = 8,
                           th: float = 7.0):
    """Motion-model tracking over explicit per-keypoint world points
    (tag = map point slot, or -1 for a visual-odometry point).

    Returns (R, t, cur_tag (N,), cur_xyz (N, 3), n_map_inliers,
    n_total_inliers, n_matches); cur_tag is -2 where unmatched, and
    n_matches is the count before pose optimization."""
    N = cur.xy.shape[0]
    dev = cur.xy.device
    p_cam = se3_apply(R_pred, t_pred, last_xyz)
    uv = project(cam, p_cam)
    proj_valid = last_has & (p_cam[..., 2] > 0.05) & _in_image(cam, uv)
    lvl = last_feats.level
    idx, _, ok = search_by_projection_points(
        uv, last_feats.desc, proj_valid, th * sf_pow(scale_factor, lvl),
        torch.clamp(lvl - 1, min=0), lvl + 1,
        cur.xy, cur.desc, cur.level, cur.angle, cur.valid,
        max_dist=TH_HIGH, nn_ratio=0.0,
    )
    ok = rotation_consistency_mask(last_feats.angle, cur.angle[idx], ok)

    # Keypoint idx[e] inherits last keypoint e's point for each accepted
    # match e. Rejected rows go to index N and are dropped; accepted rows
    # have unique targets (resolve_duplicates inside the search).
    idx_eff = torch.where(ok, idx, N)
    cur_tag = scatter_last_dropping(
        torch.full((N,), -2, dtype=torch.int32, device=dev), idx_eff, last_tag.to(torch.int32))
    cur_xyz = scatter_last_dropping(torch.zeros((N, 3), device=dev), idx_eff, last_xyz)
    matched = scatter_last_dropping(
        torch.zeros(N, dtype=torch.bool, device=dev), idx_eff,
        torch.ones_like(ok)) & cur.valid
    cur_tag = torch.where(matched, cur_tag, -2)
    cur_xyz = torch.where(matched[:, None], cur_xyz, 0.0)
    n_matches = matched.sum()

    uvr = torch.cat([cur.xy, cur.u_right[:, None]], dim=-1)
    inv_s2 = inv_sigma2_table[torch.clamp(cur.level, 0, inv_sigma2_table.shape[0] - 1).long()]
    obs = PoseObs(pts_w=cur_xyz, uvr=uvr, inv_sigma2=inv_s2, valid=matched)
    R, t, inliers, n_tot = pose_optimization(cam, R_pred, t_pred, obs)
    rejected = matched & ~inliers
    cur_tag = torch.where(rejected, -2, cur_tag)
    cur_xyz = torch.where(rejected[:, None], 0.0, cur_xyz)
    n_map = (inliers & (cur_tag >= 0)).sum()
    return R, t, cur_tag, cur_xyz, n_map, n_tot, n_matches


def track_reference_keyframe(cam: PinholeCamera, m: MapState, kf, cur: FrameFeatures,
                             R0, t0, inv_sigma2_table):
    """TrackReferenceKeyFrame: descriptor-match the current frame against
    the reference keyframe's map points (dense masked matching, ratio 0.7,
    rotation consistency), then pose-optimize from the last frame's pose.
    Returns (R, t, obs_pt (N,), n_matches, n_map_inliers)."""
    obs_k = m.kf_obs_pt[kf]
    has_k = (obs_k >= 0) & m.kf_kp_valid[kf] & _take(m.pt_valid, obs_k)
    pair = cur.valid[:, None] & has_k[None, :]
    idx, dist, ok = match_nn_ratio(cur.desc, m.kf_kp_desc[kf], pair, max_dist=TH_LOW, nn_ratio=0.7)
    ok = rotation_consistency_mask(cur.angle, m.kf_kp_angle[kf][idx], ok)
    ok = resolve_duplicates(idx, dist, ok, m.kf_kp_desc.shape[1])
    n_matches = ok.sum()
    obs_pt = torch.where(ok, obs_k[idx], -1)
    R, t, obs_pt2, n_inl = _optimize_frame_pose(cam, m, cur, obs_pt, R0, t0, inv_sigma2_table)
    return R, t, obs_pt2, n_matches, n_inl


def optimize_frame_pose(cam, m, cur, obs_pt, R0, t0, inv_sigma2_table):
    """Pose optimization from an observation assignment (the
    PoseOptimization calls of Tracking::Relocalization). Returns
    (R, t, obs_pt, n_inliers)."""
    return _optimize_frame_pose(cam, m, cur, obs_pt, R0, t0, inv_sigma2_table)


def tracked_map_points(m: MapState, kf, min_obs):
    """KeyFrame::TrackedMapPoints: the number of the keyframe's observed
    map points with >= min_obs observations in all."""
    P = m.capacity_pt
    has = (m.kf_obs_pt >= 0) & m.kf_kp_valid & m.kf_valid[:, None]
    flat = torch.where(has, m.kf_obs_pt, P).reshape(-1).long()
    cnt = torch.zeros(P + 1, dtype=torch.float32, device=flat.device).index_add(
        0, flat, torch.ones(flat.shape, dtype=torch.float32, device=flat.device))[:P]
    obs_k = m.kf_obs_pt[kf]
    ok = ((obs_k >= 0) & m.kf_kp_valid[kf] & _take(m.pt_valid, obs_k)
          & (_take(cnt, obs_k) >= min_obs))
    return ok.sum()


def keyframe_gates(m: MapState, ref_kf, feats: FrameFeatures, obs_pt, th_depth,
                   depth: bool = False):
    """The scalar inputs of Tracking::NeedNewKeyFrame as one (4,) float32
    tensor: [n_valid_kf, ref_kf_tracked_matches, tracked_close,
    untracked_close]. min_obs for the reference count is 2 with at most
    two keyframes, else 3."""
    n_kf = m.kf_valid.to(torch.float32).sum()
    min_obs = torch.where(n_kf <= 2, 2.0, 3.0)
    ref_matches = tracked_map_points(m, ref_kf, min_obs).to(torch.float32)
    if depth:
        close = (feats.depth > 0) & (feats.depth < th_depth) & feats.valid
        tracked_close = (close & (obs_pt >= 0)).to(torch.float32).sum()
        untracked_close = (close & (obs_pt < 0)).to(torch.float32).sum()
    else:
        tracked_close = torch.zeros((), device=n_kf.device)
        untracked_close = torch.zeros((), device=n_kf.device)
    return torch.stack([n_kf, ref_matches, tracked_close, untracked_close])


def _optimize_frame_pose(cam, m, cur, obs_pt, R0, t0, inv_sigma2_table):
    """Pose-optimize the current frame from its obs_pt assignment and drop
    the outlier assignments."""
    has = (obs_pt >= 0) & cur.valid
    uvr = torch.cat([cur.xy, cur.u_right[:, None]], dim=-1)
    inv_s2 = inv_sigma2_table[torch.clamp(cur.level, 0, inv_sigma2_table.shape[0] - 1).long()]
    obs = PoseObs(pts_w=_take(m.pt_xyz, obs_pt), uvr=uvr, inv_sigma2=inv_s2, valid=has)
    R, t, inliers, n_inl = pose_optimization(cam, R0, t0, obs)
    return R, t, torch.where(inliers, obs_pt, -1), n_inl


def track_local_map(cam: PinholeCamera, m: MapState, R, t, cur: FrameFeatures, obs_pt,
                    inv_sigma2_table, scale_factor: float = 1.2, n_levels: int = 8,
                    th: float = 1.0, local_kf_mask=None, max_local_pts: int = 0,
                    cand_cap: int = 0):
    """TrackLocalMap: project the local map points through the frustum
    gates (Frame::isInFrustum), search the unmatched ones into the current
    frame, re-optimize the pose.

    Two candidate regimes, as in the JAX package: all valid points (small
    maps), or, with `local_kf_mask` and `max_local_pts`, the newest
    max_local_pts valid points observed by the masked keyframes. `cand_cap`
    > 0 compacts the frustum survivors into a block of that size before the
    descriptor search (newest first on overflow).

    Returns (R, t, obs_pt, n_inliers, visible (P,), found (P,))."""
    return _track_local_map_core(cam, m, R, t, cur, obs_pt, inv_sigma2_table, scale_factor,
                                 n_levels, th, local_kf_mask, max_local_pts, cand_cap)


def _track_local_map_core(cam: PinholeCamera, m: MapState, R, t, cur: FrameFeatures, obs_pt,
                          inv_sigma2_table, scale_factor: float = 1.2, n_levels: int = 8,
                          th: float = 1.0, local_kf_mask=None, max_local_pts: int = 0,
                          cand_cap: int = 0):
    P = m.capacity_pt
    dev = m.pt_xyz.device
    if local_kf_mask is not None and 0 < max_local_pts < P:
        has = ((m.kf_obs_pt >= 0) & m.kf_kp_valid & m.kf_valid[:, None]
               & local_kf_mask[:, None])
        ptl = torch.where(has, m.kf_obs_pt, P).reshape(-1).long()
        mark = torch.zeros(P + 1, dtype=torch.bool, device=dev).index_fill(0, ptl, True)[:P]
        mark = mark & m.pt_valid
        # Newest first (point slots are allocated in order), then ascending,
        # so duplicate resolution keeps the dense path's id order. The fill
        # P + 1 maps to -2 and sorts first.
        sel_rev = nonzero_static(mark.flip(0), max_local_pts, P + 1)
        sel = torch.sort((P - 1 - sel_rev).to(torch.int32)).values
        live = sel >= 0
        ids = sel.clamp(min=0).long()
    else:
        ids = torch.arange(P, device=dev)
        live = m.pt_valid

    xyz = m.pt_xyz[ids]
    p_cam = se3_apply(R, t, xyz)
    uv = project(cam, p_cam)
    C = -(R.T @ t)
    vec = xyz - C
    dist = torch.linalg.norm(vec, dim=-1)
    in_range = (dist >= m.pt_min_dist[ids]) & (dist <= m.pt_max_dist[ids])
    normal = m.pt_normal[ids]
    view_cos = torch.sum(vec * normal, dim=-1) / torch.clamp(
        dist * torch.linalg.norm(normal, dim=-1), min=1e-9)
    visible = live & (p_cam[:, 2] > 0.05) & _in_image(cam, uv) & in_range & (view_cos > 0.5)

    # Points already matched this frame are excluded. JAX writes False at
    # slot 0 for every unmatched keypoint, in order: the last write wins.
    already = scatter_last(torch.zeros(P, dtype=torch.bool, device=dev),
                           obs_pt.clamp(min=0), obs_pt >= 0)
    cand = visible & ~already[ids]

    max_d = m.pt_max_dist[ids]
    pred_lvl = predict_scale(dist, max_d, scale_factor, n_levels)
    radius = torch.where(view_cos > 0.998, 2.5, 4.0) * th * sf_pow(scale_factor, pred_lvl)

    # Candidate compaction: only the frustum survivors reach the Hamming
    # matrix; newest first on overflow, then ascending (fill L0 -> -1).
    L0 = ids.shape[0]
    if 0 < cand_cap < L0:
        sel_rev = nonzero_static(cand.flip(0), cand_cap, L0)
        pos = torch.sort(L0 - 1 - sel_rev).values
        j = pos.clamp(min=0)
        c_ids, c_uv, c_radius, c_lvl = ids[j], uv[j], radius[j], pred_lvl[j]
        c_cand = cand[j] & (pos >= 0)
    else:
        c_ids, c_uv, c_radius, c_lvl, c_cand = ids, uv, radius, pred_lvl, cand

    # Keypoints already assigned are not matched again.
    idx, _, ok = search_by_projection_points(
        c_uv, m.pt_desc[c_ids], c_cand, c_radius, torch.clamp(c_lvl - 1, min=0), c_lvl + 1,
        cur.xy, cur.desc, cur.level, cur.angle, cur.valid & ~(obs_pt >= 0),
        max_dist=TH_HIGH, nn_ratio=0.8, ratio_same_level_only=True,
    )
    # Rows that are not ok write the old value back, in order: a later such
    # row can erase an earlier match on the same keypoint, as in JAX.
    old = obs_pt[idx]
    obs_pt = scatter_last(obs_pt, idx, torch.where(ok & (old < 0), c_ids.to(obs_pt.dtype), old))

    R, t, obs_pt, n_inl = _optimize_frame_pose(cam, m, cur, obs_pt, R, t, inv_sigma2_table)

    # found/visible bookkeeping (MapPoint::IncreaseVisible/Found), scattered
    # back to global point ids.
    visible_g = torch.zeros(P + 1, dtype=torch.bool, device=dev).index_fill(
        0, torch.where(visible, ids, P), True)[:P]
    found = scatter_last(torch.zeros(P, dtype=torch.bool, device=dev),
                         obs_pt.clamp(min=0), obs_pt >= 0)
    return R, t, obs_pt, n_inl, visible_g, found


def local_keyframe_mask(m: MapState, obs_pt, max_kfs: int = 80, ref_kf=None) -> torch.Tensor:
    """UpdateLocalKeyFrames: keyframes observing the current frame's matched
    points, capped at the `max_kfs` best voters, plus the best voter's
    covisible neighbours (up to 10 sharing >= 15 points). With no vote,
    `ref_kf` (a host int) seeds the local map. Rankings use stable sorts,
    as jnp.argsort. Returns a (K,) bool mask."""
    K = m.kf_obs_pt.shape[0]
    P = m.capacity_pt
    dev = m.kf_obs_pt.device
    matched = torch.zeros(P + 1, dtype=torch.bool, device=dev).index_fill(
        0, torch.where(obs_pt >= 0, obs_pt, P).long(), True)
    # Slot P (no point) stays False. An item write `matched[P] = False`
    # would copy the scalar from the host and sync.
    matched = torch.cat([matched[:P], matched.new_zeros(1)])
    has = (m.kf_obs_pt >= 0) & m.kf_kp_valid & m.kf_valid[:, None]
    pt = torch.where(has, m.kf_obs_pt, P).long()
    votes = (has & matched[pt]).sum(dim=1, dtype=torch.int32)  # keyframeCounter
    if ref_kf is not None:  # a host int: no host->device copy
        seeded = votes.index_add(0, torch.full((1,), max(int(ref_kf), 0), device=dev),
                                 torch.ones(1, dtype=torch.int32, device=dev))
        votes = torch.where((votes > 0).any(), votes, seeded)
    top = torch.argsort(-votes, stable=True)[:max_kfs]
    mask = torch.zeros(K, dtype=torch.bool, device=dev).index_put((top,), votes[top] > 0)
    best = torch.argmax(votes)
    shared = shared_point_counts(m, best)
    nb = torch.argsort(-shared, stable=True)[:10]
    mask = mask.index_put((nb,), mask[nb] | ((shared[nb] >= 15.0) & (votes.max() > 0)))
    return mask & m.kf_valid


# Packed scalar layout of fused_track_frame's (FUSED_LEN,) result:
FUSED_ACCEPT = 0      # 1.0 when the frame is accepted (initial ok + TLM >= thr)
FUSED_INITIAL_OK = 1  # initial pose estimate succeeded
FUSED_USED_MM = 2     # initial estimate came from the motion model
FUSED_N_TRACKED = 3   # TrackLocalMap inlier count
FUSED_GATES = 4       # 4 scalars: keyframe_gates pack
FUSED_REL = 8         # 12: rel pose vs ref KF (R row-major 9 + t 3)
FUSED_POSE = 20       # 12: absolute T_cw (R row-major 9 + t 3)
FUSED_NM = 32         # raw motion-model match count (diagnostics)
FUSED_LEN = 33


def _fused_track_core(cam: PinholeCamera, m: MapState, last_feats: FrameFeatures, last_obs,
                      last_R, last_t, vel_R, vel_t, has_vel: bool, feats: FrameFeatures,
                      ref_kf: int, inv_sigma2_table, th_depth, accept_thr,
                      scale_factor: float, n_levels: int, min_inliers_motion: int,
                      depth: bool, max_local_pts: int, cand_cap: int):
    """The steady-state tracking step (Tracking::Track's OK path):

      motion-model track (th=7, th=14 retry when it falls short)
      -> reference-keyframe fallback when the motion model fails
      -> TrackLocalMap (+ the covisibility subset on large maps)
      -> NeedNewKeyFrame gates
      -> velocity, found/visible bookkeeping, pose relative to the ref KF.

    `has_vel` is a host bool. With a velocity the motion model's counts are
    read once (retry or not) and, after a retry, once more (its verdict):
    one or two device->host reads. Without one, none. The reference-
    keyframe branch runs only when the motion model failed, and its verdict
    stays on the device.
    """
    N = feats.xy.shape[0]
    dev = feats.xy.device
    ref_c = max(int(ref_kf), 0)

    pt_idx = last_obs
    has_pt = (pt_idx >= 0) & last_feats.valid & _take(m.pt_valid, pt_idx)
    Xw_last = _take(m.pt_xyz, pt_idx)
    R_pred, t_pred = se3_compose(vel_R, vel_t, last_R, last_t)

    def mm_at(th):
        R, t, tag, _, n_map, _, n_m = track_motion_model_pts(
            cam, last_feats, Xw_last, pt_idx, has_pt, R_pred, t_pred, feats,
            inv_sigma2_table, scale_factor=scale_factor, n_levels=n_levels, th=th,
        )
        ok = (n_m >= 20) & (n_map >= min_inliers_motion)
        return (R, t, torch.where(tag >= 0, tag, -1), n_map, n_m), bool(ok)  # one read

    if has_vel:
        mm, mm_ok = mm_at(7.0)
        if not mm_ok:
            mm, mm_ok = mm_at(14.0)  # wider-window retry (Tracking.cc:944: th=2x)
        R_mm, t_mm, obs_mm, _, nm_mm = mm
    else:
        R_mm, t_mm, obs_mm = last_R, last_t, torch.full((N,), -1, dtype=torch.int32, device=dev)
        nm_mm = torch.zeros((), dtype=torch.int64, device=dev)
        mm_ok = False

    if mm_ok:
        R0, t0, obs0 = R_mm, t_mm, obs_mm
        initial_ok = torch.ones((), dtype=torch.bool, device=dev)
    else:  # reference-keyframe fallback (TrackReferenceKeyFrame)
        R0, t0, obs0, n_matches, n_inl_ref = track_reference_keyframe(
            cam, m, ref_c, feats, last_R, last_t, inv_sigma2_table)
        initial_ok = (n_matches >= 15) & (n_inl_ref >= 10)

    local_kf_mask = None
    if 0 < max_local_pts < m.capacity_pt:
        local_kf_mask = local_keyframe_mask(m, obs0, ref_kf=ref_c)
    R2, t2, obs2, n_inl, visible, found = _track_local_map_core(
        cam, m, R0, t0, feats, obs0, inv_sigma2_table,
        scale_factor=scale_factor, n_levels=n_levels,
        local_kf_mask=local_kf_mask, max_local_pts=max_local_pts, cand_cap=cand_cap,
    )

    gates = keyframe_gates(m, ref_c, feats, obs2, th_depth, depth=depth)
    accept = initial_ok & (n_inl >= accept_thr)

    # Bookkeeping, gated on the device by acceptance.
    accf = accept.to(torch.float32)
    pt_visible = m.pt_visible + accf * visible.to(torch.float32)
    pt_found = m.pt_found + accf * found.to(torch.float32)
    vel_R2, vel_t2 = se3_compose(R2, t2, *se3_inverse(last_R, last_t))
    rel_R, rel_t = se3_compose(R2, t2, *se3_inverse(m.kf_R[ref_c], m.kf_t[ref_c]))

    packed = torch.cat([
        torch.stack([accf, initial_ok.to(torch.float32),
                     torch.full((), float(mm_ok), device=dev), n_inl.to(torch.float32)]),
        gates,
        rel_R.reshape(-1), rel_t,
        R2.reshape(-1), t2,
        nm_mm.to(torch.float32).reshape(1),
    ])
    return R2, t2, obs2, vel_R2, vel_t2, pt_visible, pt_found, packed


def fused_track_frame(cam: PinholeCamera, m: MapState, last_feats: FrameFeatures, last_obs,
                      last_R, last_t, vel_R, vel_t, has_vel: bool, feats: FrameFeatures,
                      ref_kf: int, inv_sigma2_table, th_depth, accept_thr,
                      scale_factor: float = 1.2, n_levels: int = 8,
                      min_inliers_motion: int = 10, depth: bool = False,
                      max_local_pts: int = 0, cand_cap: int = 0):
    """The steady-state frame step over precomputed FrameFeatures (the
    stereo / RGB-D / multi-stream entry; see _fused_track_core). Returns
    (R, t, obs, vel_R, vel_t, pt_visible, pt_found, packed (FUSED_LEN,))."""
    return _fused_track_core(
        cam, m, last_feats, last_obs, last_R, last_t, vel_R, vel_t, has_vel,
        feats, ref_kf, inv_sigma2_table, th_depth, accept_thr,
        scale_factor, n_levels, min_inliers_motion, depth, max_local_pts, cand_cap,
    )


def fused_track_frame_image(cam: PinholeCamera, orb, m: MapState, img: torch.Tensor,
                            last_feats: FrameFeatures, last_obs, last_R, last_t,
                            vel_R, vel_t, has_vel: bool, ref_kf: int, inv_sigma2_table,
                            accept_thr, min_inliers_motion: int = 10,
                            max_local_pts: int = 0, cand_cap: int = 0):
    """The monocular frame step from the raw (H, W) image: ORB extraction
    (both CUDA kernels on a card), undistortion and the whole tracking OK
    path. Returns (feats, *fused_track_frame outputs)."""
    from tpuslam_torch.ops.orb import extract_orb

    f = extract_orb(img, orb)
    xy = f.xy
    if abs(cam.k1) > 1e-12 or abs(cam.k2) > 1e-12:
        xy = undistort_points(cam, xy)
    n = xy.shape[0]
    feats = FrameFeatures(
        xy=xy, level=f.level, angle=f.angle, desc=f.desc, valid=f.valid,
        u_right=torch.full((n,), -1.0, device=img.device),
        depth=torch.zeros((n,), device=img.device),
    )
    out = _fused_track_core(
        cam, m, last_feats, last_obs, last_R, last_t, vel_R, vel_t, has_vel,
        feats, ref_kf, inv_sigma2_table, 0.0, accept_thr,
        orb.scale_factor, orb.n_levels, min_inliers_motion, False,
        max_local_pts, cand_cap,
    )
    return (feats,) + out
