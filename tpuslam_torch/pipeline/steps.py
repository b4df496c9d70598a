"""Tracking and mapping step functions over (MapState, frame tensors).
Port of tpuslam/pipeline/steps.py.

Each function returns what its JAX counterpart returns, in the same order.
The JAX package compiles the fused step into one program whose data-
dependent branches are lax.cond. Here the step is three pure segments
(`mm_segment`, `ref_segment`, `local_segment`, each a function of tensors
with no host read, which a card captures as a CUDA graph:
pipeline/graphs.py), and those branches are host branches between them
(`compose_track_frame`). `has_vel` is a host bool, as the tracker holds
it; the motion model's verdict is one device->host read, and the th=14
retry's one more. Everything else stays on the device. The other
segments: relocalization's (reloc_match_segment, optimize_frame_pose,
reloc_search_by_projection, polish_segment), localization mode's
(vo_motion_segment, ref_segment, polish_segment, vo_points_segment) and
MultiTracker's batched front ends (batched_mono_features,
batched_stereo_features).

Scatters follow the JAX package's rules (pipeline/_index.py): the last of
repeated writes wins, out-of-bounds writes are dropped, and the fixed-size
nonzero lists are built without a sync. Rankings that lax.top_k or a
stable argsort make in the JAX package keep their ties to the lower index
here (a stable sort).

The mapping half (LocalMapping: triangulation, point culling, fusion,
keyframe culling, local bundle adjustment) is segments too: the JAX
package's jitted mapping_front as compose_mapping_front's six (map_head,
map_tri, map_insert, map_fuse, map_fuse_apply, map_tail; the neighbour
pairs the JAX package vmaps run 4 at a time, the last chunk padded and
masked), local_ba_segment, normals_segment, compact_segment and
kf_insert_segment. They take the keyframe as a 1-element index tensor and
return only the map fields they change; the one read is the two list
lengths after map_head.
"""

from __future__ import annotations

import functools

import torch

from tpuslam_torch.geometry.camera import PinholeCamera, project, undistort_points, unproject
from tpuslam_torch.geometry.se3 import hat, se3_apply, se3_compose, se3_inverse
from tpuslam_torch.geometry.triangulation import triangulate_dlt
from tpuslam_torch.mapstate.core import (
    FrameFeatures,
    MapState,
    _nanmedian_last,
    compact_point_slots,
    compute_point_descriptors,
    covisibility_weights,
    insert_keyframe,
    insert_points,
    shared_point_counts,
    update_point_normals,
)
from tpuslam_torch.matching.hamming import hamming_matrix
from tpuslam_torch.matching.search import (
    _BIG,
    TH_HIGH,
    TH_LOW,
    match_nn_ratio,
    resolve_duplicates,
    rotation_consistency_mask,
    search_by_projection_points,
)
from tpuslam_torch.ops.orb import _stable_topk, extract_orb
from tpuslam_torch.optim.ba import BAProblem, dense_schur_bundle_adjustment
from tpuslam_torch.optim.pose import PoseObs, pose_optimization
from tpuslam_torch.pipeline._index import (
    nonzero_static,
    scatter_last,
    scatter_last_dropping,
    sf_pow,
)
from tpuslam_torch.pipeline.graphs import call_segment
from tpuslam_torch.utils.metrics import traced


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


def _row(x: torch.Tensor, kf) -> torch.Tensor:
    """x[kf] for a host int, or for a 1-element index tensor (index_select:
    indexing with a 0-d device tensor would read it on the host)."""
    if isinstance(kf, torch.Tensor):
        return x.index_select(0, kf.reshape(1).long())[0]
    return x[kf]


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
    `kf` is a host int or a 1-element index tensor. Returns (R, t, obs_pt
    (N,), n_matches, n_map_inliers)."""
    obs_k = _row(m.kf_obs_pt, kf)
    has_k = (obs_k >= 0) & _row(m.kf_kp_valid, kf) & _take(m.pt_valid, obs_k)
    pair = cur.valid[:, None] & has_k[None, :]
    idx, dist, ok = match_nn_ratio(cur.desc, _row(m.kf_kp_desc, kf), pair, max_dist=TH_LOW, nn_ratio=0.7)
    ok = rotation_consistency_mask(cur.angle, _row(m.kf_kp_angle, kf)[idx], ok)
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
    map points with >= min_obs observations in all (`kf` a host int or a
    1-element index tensor)."""
    P = m.capacity_pt
    has = (m.kf_obs_pt >= 0) & m.kf_kp_valid & m.kf_valid[:, None]
    flat = torch.where(has, m.kf_obs_pt, P).reshape(-1).long()
    cnt = torch.zeros(P + 1, dtype=torch.float32, device=flat.device).index_add(
        0, flat, torch.ones(flat.shape, dtype=torch.float32, device=flat.device))[:P]
    obs_k = _row(m.kf_obs_pt, kf)
    ok = ((obs_k >= 0) & _row(m.kf_kp_valid, kf) & _take(m.pt_valid, obs_k)
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
    `ref_kf` (a host int, or a 1-element index tensor) seeds the local map.
    Rankings use stable sorts, as jnp.argsort. Returns a (K,) bool mask."""
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
    if ref_kf is not None:  # a host int or a device index: no host->device copy
        seed = (ref_kf.reshape(1).long().clamp(min=0) if isinstance(ref_kf, torch.Tensor)
                else torch.full((1,), max(int(ref_kf), 0), device=dev))
        seeded = votes.index_add(0, seed, torch.ones(1, dtype=torch.int32, device=dev))
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


# The map fields each track segment reads: a graph's copy-in moves these
# and no others (pipeline/graphs.py), and map_fields leaves the rest None.
MM_MAP_FIELDS = ("pt_valid", "pt_xyz")
REF_MAP_FIELDS = ("kf_obs_pt", "kf_kp_valid", "kf_kp_desc", "kf_kp_angle", "pt_valid", "pt_xyz")
LOCAL_MAP_FIELDS = ("kf_valid", "kf_R", "kf_t", "kf_obs_pt", "kf_kp_valid", "pt_valid", "pt_xyz",
                    "pt_desc", "pt_normal", "pt_min_dist", "pt_max_dist", "pt_visible", "pt_found")


def map_fields(m: MapState, fields) -> MapState:
    """m with only `fields` kept, every other field None."""
    return MapState(**{f: (getattr(m, f) if f in fields else None) for f in MapState._fields})


def mm_segment(cam: PinholeCamera, m: MapState, last_feats: FrameFeatures, last_obs, last_R,
               last_t, vel_R, vel_t, feats: FrameFeatures, inv_sigma2_table, *, th: float,
               scale_factor: float, n_levels: int, min_inliers_motion: int):
    """TrackWithMotionModel at window factor `th` from the last frame's
    points, as a segment: tensors in, new tensors out, no host read.
    Returns (R, t, obs (N,) with -1 where unmatched, n_matches, ok), ok the
    verdict as a device bool (>= 20 matches, >= min_inliers_motion map
    inliers)."""
    has_pt = (last_obs >= 0) & last_feats.valid & _take(m.pt_valid, last_obs)
    R_pred, t_pred = se3_compose(vel_R, vel_t, last_R, last_t)
    R, t, tag, _, n_map, _, n_m = track_motion_model_pts(
        cam, last_feats, _take(m.pt_xyz, last_obs), last_obs, has_pt, R_pred, t_pred, feats,
        inv_sigma2_table, scale_factor=scale_factor, n_levels=n_levels, th=th,
    )
    ok = (n_m >= 20) & (n_map >= min_inliers_motion)
    return R, t, torch.where(tag >= 0, tag, -1), n_m, ok


def ref_segment(cam: PinholeCamera, m: MapState, ref_kf, feats: FrameFeatures, last_R, last_t,
                inv_sigma2_table):
    """TrackReferenceKeyFrame from the last frame's pose, as a segment
    (ref_kf a 1-element index tensor). Returns (R, t, obs, n_matches,
    n_inliers, ok), ok the verdict on the device (>= 15 matches, >= 10
    inliers)."""
    R, t, obs, n_matches, n_inl = track_reference_keyframe(
        cam, m, ref_kf, feats, last_R, last_t, inv_sigma2_table)
    return R, t, obs, n_matches, n_inl, (n_matches >= 15) & (n_inl >= 10)


def local_segment(cam: PinholeCamera, m: MapState, ref_kf, feats: FrameFeatures, R0, t0, obs0,
                  last_R, last_t, initial_ok, mm_ok, n_mm, accept_thr, inv_sigma2_table, *,
                  th_depth: float, scale_factor: float, n_levels: int, depth: bool,
                  max_local_pts: int, cand_cap: int):
    """The rest of the step from the initial estimate (R0, t0, obs0), as a
    segment: TrackLocalMap (+ the covisibility subset on large maps), the
    NeedNewKeyFrame gates, then the velocity, the found/visible bookkeeping
    gated on the device by acceptance, and the pose relative to the
    reference keyframe. ref_kf and accept_thr are 1-element tensors;
    initial_ok, mm_ok and n_mm (the motion model's raw match count) device
    scalars. Returns (R, t, obs, vel_R, vel_t, pt_visible, pt_found, packed
    (FUSED_LEN,))."""
    local_kf_mask = None
    if 0 < max_local_pts < m.capacity_pt:
        local_kf_mask = local_keyframe_mask(m, obs0, ref_kf=ref_kf)
    R2, t2, obs2, n_inl, visible, found = _track_local_map_core(
        cam, m, R0, t0, feats, obs0, inv_sigma2_table,
        scale_factor=scale_factor, n_levels=n_levels,
        local_kf_mask=local_kf_mask, max_local_pts=max_local_pts, cand_cap=cand_cap,
    )
    gates = keyframe_gates(m, ref_kf, feats, obs2, th_depth, depth=depth)
    accept = initial_ok & (n_inl >= accept_thr.reshape(()))

    accf = accept.to(torch.float32)
    pt_visible = m.pt_visible + accf * visible.to(torch.float32)
    pt_found = m.pt_found + accf * found.to(torch.float32)
    vel_R2, vel_t2 = se3_compose(R2, t2, *se3_inverse(last_R, last_t))
    rel_R, rel_t = se3_compose(R2, t2, *se3_inverse(_row(m.kf_R, ref_kf), _row(m.kf_t, ref_kf)))

    packed = torch.cat([
        torch.stack([accf, initial_ok.to(torch.float32), mm_ok.to(torch.float32),
                     n_inl.to(torch.float32)]),
        gates,
        rel_R.reshape(-1), rel_t,
        R2.reshape(-1), t2,
        n_mm.to(torch.float32).reshape(1),
    ])
    return R2, t2, obs2, vel_R2, vel_t2, pt_visible, pt_found, packed


def compose_track_frame(run, cam: PinholeCamera, m: MapState, last_feats: FrameFeatures,
                        last_obs, last_R, last_t, vel_R, vel_t, has_vel: bool,
                        feats: FrameFeatures, ref_kf, inv_sigma2_table, th_depth: float,
                        accept_thr: float, scale_factor: float, n_levels: int,
                        min_inliers_motion: int, depth: bool, max_local_pts: int, cand_cap: int):
    """The steady-state tracking step (Tracking::Track's OK path), each
    segment through `run(name, fn, static, **tensors)` (call_segment, or
    StepGraphs.run):

      mm_segment at th=7, at th=14 when it falls short (Tracking.cc:944)
      -> ref_segment without a velocity or after a failed motion model
      -> local_segment.

    The host takes the branches: with a velocity the motion model's verdict
    is read once, and after a th=14 retry once more (one or two
    device->host reads); without one, none. ref_kf (a host int) and
    accept_thr go in as 1-element device tensors. Returns local_segment's
    outputs."""
    dev = feats.xy.device
    ref = torch.full((1,), max(int(ref_kf), 0), dtype=torch.int64, device=dev)
    thr = torch.full((1,), float(accept_thr), device=dev)
    mm_ok = False
    n_mm = torch.zeros((), dtype=torch.int64, device=dev)
    if has_vel:
        for th in (7.0, 14.0):
            R0, t0, obs0, n_mm, ok = run(
                "mm", mm_segment,
                dict(cam=cam, th=th, scale_factor=scale_factor, n_levels=n_levels,
                     min_inliers_motion=min_inliers_motion),
                m=map_fields(m, MM_MAP_FIELDS), last_feats=last_feats, last_obs=last_obs,
                last_R=last_R, last_t=last_t, vel_R=vel_R, vel_t=vel_t, feats=feats,
                inv_sigma2_table=inv_sigma2_table)
            with traced("read.verdict"):
                mm_ok = bool(ok)  # the verdict: one read
            if mm_ok:
                break
    if mm_ok:
        initial_ok = torch.ones((), dtype=torch.bool, device=dev)
    else:  # reference-keyframe fallback (TrackReferenceKeyFrame)
        R0, t0, obs0, _, _, initial_ok = run(
            "ref", ref_segment, dict(cam=cam),
            m=map_fields(m, REF_MAP_FIELDS), ref_kf=ref, feats=feats, last_R=last_R,
            last_t=last_t, inv_sigma2_table=inv_sigma2_table)
    return run(
        "local", local_segment,
        dict(cam=cam, th_depth=float(th_depth), scale_factor=scale_factor, n_levels=n_levels,
             depth=depth, max_local_pts=max_local_pts, cand_cap=cand_cap),
        m=map_fields(m, LOCAL_MAP_FIELDS), ref_kf=ref, feats=feats, R0=R0, t0=t0, obs0=obs0,
        last_R=last_R, last_t=last_t, initial_ok=initial_ok,
        mm_ok=torch.full((), mm_ok, dtype=torch.bool, device=dev), n_mm=n_mm, accept_thr=thr,
        inv_sigma2_table=inv_sigma2_table)


def fused_track_frame(cam: PinholeCamera, m: MapState, last_feats: FrameFeatures, last_obs,
                      last_R, last_t, vel_R, vel_t, has_vel: bool, feats: FrameFeatures,
                      ref_kf: int, inv_sigma2_table, th_depth, accept_thr,
                      scale_factor: float = 1.2, n_levels: int = 8,
                      min_inliers_motion: int = 10, depth: bool = False,
                      max_local_pts: int = 0, cand_cap: int = 0, run=call_segment):
    """The steady-state frame step over precomputed FrameFeatures (the
    stereo / RGB-D / multi-stream entry): compose_track_frame's segments,
    each through `run` (eagerly by default; StepGraphs.run replays them).
    Returns (R, t, obs, vel_R, vel_t, pt_visible, pt_found, packed
    (FUSED_LEN,))."""
    return compose_track_frame(
        run, cam, m, last_feats, last_obs, last_R, last_t, vel_R, vel_t, has_vel,
        feats, ref_kf, inv_sigma2_table, th_depth, accept_thr,
        scale_factor, n_levels, min_inliers_motion, depth, max_local_pts, cand_cap,
    )


def mono_features(cam: PinholeCamera, f) -> FrameFeatures:
    """FrameFeatures of one image's ORBFeatures: undistorted xy, no depth."""
    xy = f.xy
    if abs(cam.k1) > 1e-12 or abs(cam.k2) > 1e-12:
        xy = undistort_points(cam, xy)
    n = xy.shape[0]
    return FrameFeatures(xy=xy, level=f.level, angle=f.angle, desc=f.desc, valid=f.valid,
                         u_right=torch.full((n,), -1.0, device=xy.device),
                         depth=torch.zeros((n,), device=xy.device))


def mono_frame_features(img: torch.Tensor, cam: PinholeCamera, orb) -> FrameFeatures:
    """A monocular frame's FrameFeatures from the raw (H, W) image: ORB
    extraction (both CUDA kernels on a card) and undistortion. No
    device->host read on a card."""
    return mono_features(cam, extract_orb(img, orb))


def rgbd_frame_features(img: torch.Tensor, depth_map: torch.Tensor, cam: PinholeCamera, orb,
                        depth_map_factor: float) -> FrameFeatures:
    """Frame::ComputeStereoFromRGBD: the depth image (scaled by
    depth_map_factor) at each keypoint's raw, distorted position, and the
    virtual right coordinate from the undistorted one. One extraction gives
    both positions; no device->host read on a card."""
    f = extract_orb(img, orb)
    feats = mono_features(cam, f)
    H, W = depth_map.shape
    xs = torch.clamp(torch.round(f.xy[:, 0]).long(), 0, W - 1)
    ys = torch.clamp(torch.round(f.xy[:, 1]).long(), 0, H - 1)
    d = depth_map[ys, xs] * depth_map_factor
    has_d = (d > 0) & feats.valid
    # float32(bf) / d, a true division, as the JAX package divides.
    ur = feats.xy[:, 0] - torch.full_like(d, cam.bf) / torch.clamp(d, min=1e-6)
    return feats._replace(u_right=torch.where(has_d, ur, -1.0),
                          depth=torch.where(has_d, d, 0.0))


def fused_track_frame_image(cam: PinholeCamera, orb, m: MapState, img: torch.Tensor,
                            last_feats: FrameFeatures, last_obs, last_R, last_t,
                            vel_R, vel_t, has_vel: bool, ref_kf: int, inv_sigma2_table,
                            accept_thr, min_inliers_motion: int = 10,
                            max_local_pts: int = 0, cand_cap: int = 0, run=call_segment):
    """The monocular frame step from the raw (H, W) image: mono_frame_features
    (the segment "front") and the whole tracking OK path, each segment
    through `run`. Returns (feats, *fused_track_frame outputs)."""
    feats = run("front", mono_frame_features, dict(cam=cam, orb=orb), img=img)
    out = compose_track_frame(
        run, cam, m, last_feats, last_obs, last_R, last_t, vel_R, vel_t, has_vel,
        feats, ref_kf, inv_sigma2_table, 0.0, accept_thr,
        orb.scale_factor, orb.n_levels, min_inliers_motion, False,
        max_local_pts, cand_cap,
    )
    return (feats,) + tuple(out)


def stereo_features(fb, atlas: torch.Tensor, left: int, right: int, img_shape: tuple,
                    config, fx: float, bf: float) -> FrameFeatures:
    """A stereo frame's FrameFeatures from a batched extraction: streams
    `left` and `right` of the batch features `fb` (ORBFeatures, (B, N,
    ...)) of (H, W) = img_shape images, matched by ops/stereo.py over the
    extraction's own atlas (each stream's slab holds its whole pyramid).
    u_right = -1 and depth = 0 where unmatched."""
    from tpuslam_torch.ops.image import pyramid_shapes
    from tpuslam_torch.ops.orb import ORBFeatures
    from tpuslam_torch.ops.stereo import stereo_match_atlas

    fL = ORBFeatures(*(leaf[left] for leaf in fb))
    fR = ORBFeatures(*(leaf[right] for leaf in fb))
    Ha = atlas.shape[0] // fb.xy.shape[0]
    shapes = tuple(pyramid_shapes(*img_shape, config.n_levels, config.scale_factor))
    u_right, depth, ok = stereo_match_atlas(fL, fR, atlas, left * Ha, right * Ha, shapes,
                                            config, fx, bf)
    return FrameFeatures(xy=fL.xy, level=fL.level, angle=fL.angle, desc=fL.desc, valid=fL.valid,
                         u_right=torch.where(ok, u_right, -1.0),
                         depth=torch.where(ok, depth, 0.0))


def stereo_frame_features(imgL: torch.Tensor, imgR: torch.Tensor, config, fx: float,
                          bf: float) -> FrameFeatures:
    """Stereo Frame construction: ORB on both (H, W) images as one B=2
    extraction (one FAST+NMS launch, one descriptor gather), then stereo
    matching with SAD refinement over the extraction's atlas (one more
    gather). No device->host read. Returns the left frame's FrameFeatures
    with u_right and depth filled."""
    from tpuslam_torch.ops.orb import extract_orb_batched_atlas

    fb, atlas = extract_orb_batched_atlas(torch.stack([imgL, imgR]), config)
    return stereo_features(fb, atlas, 0, 1, tuple(imgL.shape[-2:]), config, fx, bf)


def batched_mono_features(imgs: torch.Tensor, orb, streams: tuple, cams: tuple) -> tuple:
    """MultiTracker's monocular front end as a segment: ORB on all (B, H,
    W) images in one batch, then the FrameFeatures (undistorted) of each
    stream in `streams` with its camera in `cams`, as a tuple."""
    from tpuslam_torch.ops.orb import ORBFeatures, extract_orb_batched

    fb = extract_orb_batched(imgs, orb)
    return tuple(mono_features(cam, ORBFeatures(*(leaf[b] for leaf in fb)))
                 for b, cam in zip(streams, cams))


def batched_stereo_features(imgs: torch.Tensor, orb, cams: tuple) -> tuple:
    """MultiTracker's stereo front end as a segment: ORB on the 2B (H, W)
    images (B left, then B right) in one batch, then each stream's stereo
    matching over the batch's atlas with its camera in `cams`. Returns B
    FrameFeatures."""
    from tpuslam_torch.ops.orb import extract_orb_batched_atlas

    B = len(cams)
    fb, atlas = extract_orb_batched_atlas(imgs, orb)
    return tuple(stereo_features(fb, atlas, b, B + b, tuple(imgs.shape[-2:]), orb, c.fx, c.bf)
                 for b, c in enumerate(cams))


# ---------------------------------------------------------------------------
# Relocalization and LocalMapping.
# ---------------------------------------------------------------------------

def reloc_search_by_projection(cam: PinholeCamera, m: MapState, kf, R, t, cur: FrameFeatures,
                               obs_pt, scale_factor: float = 1.2, n_levels: int = 8,
                               window: float = 10.0, max_desc_dist: int = 100):
    """Relocalization's projective widening (ORBmatcher::SearchByProjection,
    the relocalization variant): project keyframe `kf`'s map points (`kf` a
    host int or a 1-element index tensor) with the current pose estimate
    and match them into still-free keypoints, skipping points already
    found. A segment with `kf` a tensor. Returns (obs_pt, n_added)."""
    P = m.capacity_pt
    dev = m.pt_xyz.device
    obs_k = _row(m.kf_obs_pt, kf)
    pt_idx = obs_k.clamp(min=0).long()
    has_k = (obs_k >= 0) & _row(m.kf_kp_valid, kf) & m.pt_valid[pt_idx]
    # Points already assigned this frame (JAX writes False at slot 0 for
    # every unassigned keypoint, in order: the last write wins).
    already = scatter_last(torch.zeros(P, dtype=torch.bool, device=dev), obs_pt.clamp(min=0), obs_pt >= 0)
    Xw = m.pt_xyz[pt_idx]
    p_cam = se3_apply(R, t, Xw)
    uv = project(cam, p_cam)
    dist_w = torch.linalg.norm(Xw - (-(R.T @ t)), dim=-1)
    in_range = (dist_w >= m.pt_min_dist[pt_idx]) & (dist_w <= m.pt_max_dist[pt_idx])
    cand = has_k & ~already[pt_idx] & (p_cam[:, 2] > 0.05) & _in_image(cam, uv) & in_range
    pred_lvl = predict_scale(dist_w, m.pt_max_dist[pt_idx], scale_factor, n_levels)
    idx, _, ok = search_by_projection_points(
        uv, m.pt_desc[pt_idx], cand, window * sf_pow(scale_factor, pred_lvl),
        torch.clamp(pred_lvl - 1, min=0), pred_lvl + 1,
        cur.xy, cur.desc, cur.level, cur.angle, cur.valid & ~(obs_pt >= 0),
        max_dist=max_desc_dist, nn_ratio=0.0,
    )
    # Row e holds the candidate point of keyframe slot e; its match is idx[e].
    old = obs_pt[idx]
    new_obs = scatter_last(obs_pt, idx, torch.where(ok & (old < 0), obs_k, old))
    return new_obs, (new_obs >= 0).sum() - (obs_pt >= 0).sum()


# The map fields of relocalization's and localization mode's segments
# (the copy-in moves these and no others).
RELOC_MATCH_FIELDS = ("kf_obs_pt", "kf_kp_valid", "kf_kp_desc", "pt_valid")
RELOC_SEARCH_FIELDS = ("kf_obs_pt", "kf_kp_valid", "pt_valid", "pt_xyz", "pt_desc", "pt_min_dist",
                       "pt_max_dist")
POSE_MAP_FIELDS = ("pt_xyz",)
POLISH_MAP_FIELDS = ("kf_valid", "kf_obs_pt", "kf_kp_valid", "pt_valid", "pt_xyz", "pt_desc",
                     "pt_normal", "pt_min_dist", "pt_max_dist")


def reloc_match_segment(m: MapState, kf, feats: FrameFeatures):
    """Relocalization's SearchByBoW step as a segment: the frame's
    keypoints against keyframe kf's (a 1-element index tensor) map points,
    distance 50, ratio 0.75. Returns (pt_idx (N,), -1 where unmatched; ok
    (N,))."""
    obs_k = _row(m.kf_obs_pt, kf)
    has_k = (obs_k >= 0) & _row(m.kf_kp_valid, kf) & _take(m.pt_valid, obs_k)
    idx, _, ok = match_nn_ratio(feats.desc, _row(m.kf_kp_desc, kf),
                                feats.valid[:, None] & has_k[None, :], max_dist=50, nn_ratio=0.75)
    return torch.where(ok, obs_k[idx], -1), ok


def polish_segment(cam: PinholeCamera, m: MapState, ref_kf, feats: FrameFeatures, R, t, obs,
                   inv_sigma2_table, *, scale_factor: float, n_levels: int, max_local_pts: int,
                   cand_cap: int):
    """TrackLocalMap from a pose and its assignment, as a segment (the
    polish of relocalization and of localization mode): over the whole map,
    or with 0 < max_local_pts < P over the covisibility-local subset seeded
    by ref_kf (a 1-element index tensor) when nothing votes. Returns
    track_local_map's (R, t, obs, n_inliers, visible, found)."""
    local_kf_mask = None
    if 0 < max_local_pts < m.capacity_pt:
        local_kf_mask = local_keyframe_mask(m, obs, ref_kf=ref_kf)
    return track_local_map(cam, m, R, t, feats, obs, inv_sigma2_table, scale_factor, n_levels,
                           local_kf_mask=local_kf_mask, max_local_pts=max_local_pts, cand_cap=cand_cap)


def vo_motion_segment(cam: PinholeCamera, m: MapState, last_feats: FrameFeatures, last_obs, vo_xyz,
                      vo_valid, last_R, last_t, vel_R, vel_t, feats: FrameFeatures,
                      inv_sigma2_table, *, th: float, scale_factor: float, n_levels: int):
    """Localization mode's motion model at window factor `th`, as a
    segment: the last frame's map points and, where it holds none, its
    visual-odometry points (vo_xyz (N, 3) and vo_valid (N,), or None
    before the first), tracked from the velocity's prediction. Returns
    track_motion_model_pts's (R, t, cur_tag, cur_xyz, n_map, n_total,
    n_matches)."""
    has_map = (last_obs >= 0) & last_feats.valid & _take(m.pt_valid, last_obs)
    xyz = _take(m.pt_xyz, last_obs)
    tags = torch.where(has_map, last_obs, -1)
    has = has_map
    if vo_xyz is not None:
        vo = vo_valid & ~has_map & last_feats.valid
        xyz = torch.where(vo[:, None], vo_xyz, xyz)
        has = has_map | vo
    R_pred, t_pred = se3_compose(vel_R, vel_t, last_R, last_t)
    return track_motion_model_pts(cam, last_feats, xyz, tags, has, R_pred, t_pred, feats,
                                  inv_sigma2_table, scale_factor=scale_factor, n_levels=n_levels, th=th)


def vo_points_segment(cam: PinholeCamera, feats: FrameFeatures, cur_tag, cur_xyz, R, t, *,
                      th_depth: float):
    """The next frame's visual-odometry points (Tracking::UpdateLastFrame),
    as a segment: the keypoints with depth that track no map point, every
    one closer than th_depth and the 100 nearest in any case, unprojected
    into the world; a carried VO match (tag -1) keeps its position.
    Returns (vo_xyz (N, 3), vo_valid (N,))."""
    d = feats.depth
    has_d = (d > 0) & feats.valid
    order_d = torch.where(has_d, d, float("inf"))
    # The rank of each depth, ties by index (jnp.argsort is stable).
    rank = torch.argsort(torch.argsort(order_d, stable=True), stable=True)
    create = has_d & (cur_tag < 0) & ((d < th_depth) | (rank < 100))
    Xw = se3_apply(*se3_inverse(R, t), unproject(cam, feats.xy, d))
    carried = cur_tag == -1
    return torch.where(carried[:, None], cur_xyz, Xw), carried | create


@functools.lru_cache(maxsize=None)
def _intrinsics(cam: PinholeCamera, device: torch.device):
    """(K, K^-1) on `device`, copied there once per camera and device."""
    return cam.K.to(device), torch.linalg.inv(cam.K).to(device)


def triangulate_new_points(cam: PinholeCamera, m: MapState, kf_new, kf_old, inv_sigma2_table,
                           scale_factor: float = 1.2, n_levels: int = 8):
    """LocalMapping::CreateNewMapPoints between keyframe `kf_new` (a host
    int or a 1-element index tensor) and each of the keyframes `kf_old` (a
    (C,) tensor: C pairs at once): epipolar-constrained matching of
    unmatched keypoints, two-view triangulation, cheirality / parallax /
    reprojection / scale-consistency vetting.

    Returns (xyz (C, N, 3), desc (N, 8), normals (C, N, 3), min_d (C, N),
    max_d (C, N), slot_new (N,), slot_old (C, N), good (C, N)): one candidate
    point per new-keyframe keypoint and pair."""
    N = m.kf_kp_xy.shape[1]
    dev = m.kf_R.device
    ko = kf_old.long()

    def new(x):
        return _row(x, kf_new)

    R1, t1 = m.kf_R[ko], m.kf_t[ko]             # (C, 3, 3), (C, 3)
    R2, t2 = new(m.kf_R), new(m.kf_t)           # (3, 3), (3,)
    C1 = -(R1.transpose(-1, -2) @ t1[..., None])[..., 0]
    C2 = -(R2.T @ t2)

    # Baseline gate: skip a pair whose baseline is below 1% of the new
    # keyframe's median scene depth.
    obs_new = new(m.kf_obs_pt)
    obs_ok = (obs_new >= 0) & new(m.kf_kp_valid)
    pc = se3_apply(R2, t2, m.pt_xyz[obs_new.clamp(min=0).long()])
    med = _nanmedian_last(torch.where(obs_ok, pc[:, 2], float("nan")))
    med = torch.where(torch.isnan(med), 1.0, med)
    pair_ok = torch.linalg.norm(C2 - C1, dim=-1) > 0.01 * med  # (C,)
    free1 = m.kf_kp_valid[ko] & (m.kf_obs_pt[ko] < 0) & pair_ok[:, None]
    free2 = new(m.kf_kp_valid) & (new(m.kf_obs_pt) < 0) & pair_ok[:, None]

    # F12 relates old (1) to new (2); the epipolar line of an old keypoint
    # in the new image is F12^T x1.
    R12 = R1 @ R2.T
    t12 = t1 - (R12 @ t2[:, None])[..., 0]
    K, Kinv = _intrinsics(cam, dev)
    F12 = Kinv.T @ hat(t12) @ R12 @ Kinv
    xy1, xy2 = m.kf_kp_xy[ko], new(m.kf_kp_xy)
    ones = torch.ones((*xy1.shape[:-1], 1), device=dev)
    l2 = torch.cat([xy1, ones], dim=-1) @ F12  # (C, N, 3)
    x2h = torch.cat([xy2, ones[0]], dim=-1)
    num = torch.abs(l2 @ x2h.T)  # (C, N1, N2)
    den = torch.sqrt(torch.clamp(l2[..., 0] ** 2 + l2[..., 1] ** 2, min=1e-12))[..., None]
    lvl_new = torch.clamp(new(m.kf_kp_level), 0, n_levels - 1).long()
    epi_ok = (num / den) ** 2 < 3.84 * (1.0 / inv_sigma2_table[lvl_new])

    pair = free1[:, :, None] & free2[:, None, :] & epi_ok
    dist = torch.where(pair, hamming_matrix(m.kf_kp_desc[ko], new(m.kf_kp_desc)), _BIG)
    i1 = torch.argmin(dist, dim=1)  # best old keypoint for each new one (the first)
    d1 = torch.gather(dist, 1, i1[:, None])[:, 0]
    matched = d1 <= TH_LOW
    ang_old = torch.gather(m.kf_kp_angle[ko], 1, i1)
    matched = rotation_consistency_mask(ang_old, new(m.kf_kp_angle), matched)
    matched = resolve_duplicates(i1, d1, matched, N)

    C = ko.shape[0]
    uv1m = torch.gather(xy1, 1, i1[..., None].expand(C, N, 2))
    P1 = K @ torch.cat([R1, t1[..., None]], dim=-1)
    P2 = K @ torch.cat([R2, t2[:, None]], dim=-1)
    Xw, w = triangulate_dlt(P1[:, None].expand(C, N, 3, 4), P2.expand(C, N, 3, 4),
                            uv1m, xy2.expand(C, N, 2))
    finite = torch.all(torch.isfinite(Xw), dim=-1) & (torch.abs(w) > 1e-9)

    r1v = Xw - C1[:, None]
    r2v = Xw - C2
    d1v = torch.linalg.norm(r1v, dim=-1)
    d2v = torch.linalg.norm(r2v, dim=-1)
    cosp = torch.sum(r1v * r2v, dim=-1) / torch.clamp(d1v * d2v, min=1e-12)
    parallax_ok = cosp < 0.9998

    p1 = se3_apply(R1, t1[:, None], Xw)
    p2 = se3_apply(R2, t2, Xw)
    lvl_old = torch.clamp(torch.gather(m.kf_kp_level[ko], 1, i1), 0, n_levels - 1).long()
    e1 = torch.sum((project(cam, p1) - uv1m) ** 2, dim=-1)
    e2 = torch.sum((project(cam, p2) - xy2) ** 2, dim=-1)
    reproj_ok = ((e1 < 5.991 * (1.0 / inv_sigma2_table[lvl_old]))
                 & (e2 < 5.991 * (1.0 / inv_sigma2_table[lvl_new])))
    chei = (p1[..., 2] > 0) & (p2[..., 2] > 0)

    sf1 = sf_pow(scale_factor, torch.gather(m.kf_kp_level[ko], 1, i1))
    sf2 = sf_pow(scale_factor, new(m.kf_kp_level))
    ratio_d = d1v / torch.clamp(d2v, min=1e-9)
    ratio_o = sf1 / sf2
    ratio_factor = 1.5 * scale_factor
    scale_ok = (ratio_d < ratio_o * ratio_factor) & (ratio_d > ratio_o / ratio_factor)

    good = matched & finite & parallax_ok & chei & reproj_ok & scale_ok
    nvec = r2v / torch.clamp(torch.linalg.norm(r2v, dim=-1, keepdim=True), min=1e-9)
    max_d = d2v * sf2
    min_d = max_d / (scale_factor ** (n_levels - 1))
    return (Xw, new(m.kf_kp_desc), nvec, 0.8 * min_d, 1.2 * max_d,
            torch.arange(N, dtype=torch.int32, device=dev), i1.to(torch.int32), good)


def build_local_ba_problem(m: MapState, center_kf, window: int):
    """The bundle-adjustment edges over the centre keyframe's covisibility
    neighbourhood (Optimizer::LocalBundleAdjustment), the centre a host int
    or a 1-element index tensor (no host read). Active: the centre and
    every keyframe sharing >= 15 points with it, or, with none, the `window`
    newest keyframes by frame id. Fixed: every other valid keyframe and
    keyframe 0. Returns (kf (K*N,), pt (K*N,), uvr (K*N, 3), has (K*N,),
    fixed_kf (K,), fixed_pt (P,))."""
    K, N = m.kf_obs_pt.shape
    P = m.capacity_pt
    dev = m.kf_R.device
    idx = torch.arange(K, device=dev)
    fid = m.kf_frame_id
    eligible = m.kf_valid & (fid <= fid[center_kf])
    newer = eligible[None, :] & (fid[None, :] > fid[:, None])
    recency = eligible & (newer.sum(dim=1) < window)
    shared = shared_point_counts(m, center_kf)
    covis = m.kf_valid & (shared >= 15.0) & (idx != center_kf)
    active = torch.where(covis.any(), covis | (m.kf_valid & (idx == center_kf)), recency)
    fixed_kf = m.kf_valid & ~active | (idx == 0)

    kfi = torch.arange(K, dtype=torch.int32, device=dev).repeat_interleave(N)
    pti = m.kf_obs_pt.reshape(-1)
    has = (pti >= 0) & m.kf_kp_valid.reshape(-1) & m.kf_valid[kfi.long()]
    uvr = torch.cat([m.kf_kp_xy.reshape(K * N, 2), m.kf_kp_uright.reshape(K * N, 1)], dim=-1)
    seen_active = torch.zeros(P + 1, dtype=torch.bool, device=dev).index_fill(
        0, torch.where(has & active[kfi.long()], pti, P).long(), True)[:P]
    return kfi, pti.clamp(min=0), uvr, has, fixed_kf, ~seen_active


def local_bundle_adjustment(cam: PinholeCamera, m: MapState, center_kf, inv_sigma2_table,
                            window: int = 8, iters: int = 8, n_levels: int = 8,
                            max_edges: int = 65536, active_max: int = 32) -> MapState:
    """Local BA over the centre keyframe's covisibility neighbourhood, the
    optimized poses and points written back and outlier observations
    detached (chi2 > 5.991 mono / 7.815 stereo).

    The adjustable keyframes are ranked (centre first, then by points shared
    with it) into `active_max` slots for the dense reduced-camera solve; the
    rest become fixed. With `max_edges` below K*N the solver runs on a
    compacted block of the edges with an adjustable end, edges of active
    keyframes first on overflow (a stable sort keeps slot order)."""
    K, N = m.kf_obs_pt.shape
    dev = m.kf_R.device
    kfi, pti, uvr, has, fixed_kf, fixed_pt = build_local_ba_problem(m, center_kf, window)
    adjustable = m.kf_valid & ~fixed_kf
    score = torch.where(adjustable, shared_point_counts(m, center_kf) + 1.0, -1.0)
    score = torch.where(torch.arange(K, device=dev) == center_kf, float("inf"), score)
    vals, idx = _stable_topk(score, min(active_max, K))
    active_idx = torch.where(vals > 0, idx, -1)
    in_active = torch.zeros(K + 1, dtype=torch.bool, device=dev).index_fill(
        0, torch.where(active_idx >= 0, active_idx, K), True)[:K]
    fixed_kf = fixed_kf | (adjustable & ~in_active)

    kfl, ptl = kfi.long(), pti.long()
    inv_s2 = inv_sigma2_table[torch.clamp(m.kf_kp_level.reshape(-1), 0, inv_sigma2_table.shape[0] - 1).long()]
    valid_e = has & m.pt_valid[ptl]
    E = K * N
    cap = min(max_edges, E) if max_edges else E
    obs = m.kf_obs_pt.reshape(-1)
    if cap < E:
        useful = valid_e & (~fixed_kf[kfl] | ~fixed_pt[ptl])
        prio = useful.to(torch.int32) * (1 + (~fixed_kf[kfl]).to(torch.int32))
        sel = torch.argsort(-prio, stable=True)[:cap]
        prob = BAProblem(R=m.kf_R, t=m.kf_t, X=m.pt_xyz, kf=kfi[sel], pt=pti[sel], uvr=uvr[sel],
                         inv_sigma2=inv_s2[sel], valid=valid_e[sel] & (prio[sel] > 0),
                         fixed_kf=fixed_kf, fixed_pt=fixed_pt)
    else:
        sel = None
        prob = BAProblem(R=m.kf_R, t=m.kf_t, X=m.pt_xyz, kf=kfi, pt=pti, uvr=uvr,
                         inv_sigma2=inv_s2, valid=valid_e, fixed_kf=fixed_kf, fixed_pt=fixed_pt)
    R, t, X, chi2 = dense_schur_bundle_adjustment(cam, prob, active_idx, iters=iters, use_huber=True)
    th = torch.where(prob.uvr[:, 2] >= 0, 7.815, 5.991)
    bad = prob.valid & (chi2 > th)
    if sel is None:
        obs = torch.where(bad, -1, obs)
    else:
        obs = obs.index_put((sel,), torch.where(bad, -1, obs[sel]))
    return m._replace(kf_R=R, kf_t=t, pt_xyz=X, kf_obs_pt=obs.reshape(K, N))


# The map fields the local BA reads, and those it changes.
LOCAL_BA_FIELDS = ("kf_R", "kf_t", "kf_valid", "kf_frame_id", "kf_obs_pt", "kf_kp_valid", "kf_kp_xy",
                   "kf_kp_uright", "kf_kp_level", "pt_xyz", "pt_valid")
LOCAL_BA_CHANGED = ("kf_R", "kf_t", "pt_xyz", "kf_obs_pt")


def local_ba_segment(cam: PinholeCamera, m: MapState, center_kf, inv_sigma2_table, *, window: int,
                     iters: int, n_levels: int, max_edges: int, active_max: int) -> MapState:
    """local_bundle_adjustment as a segment: the centre a 1-element index
    tensor, the chi2 detach inside. Returns the changed fields (poses,
    points, the observation table), every other field None."""
    out = local_bundle_adjustment(cam, m, center_kf, inv_sigma2_table, window=window, iters=iters,
                                  n_levels=n_levels, max_edges=max_edges, active_max=active_max)
    return map_fields(out, LOCAL_BA_CHANGED)


def _observation_counts(m: MapState) -> torch.Tensor:
    """(P + 1,) float32 keyframe observations of each point (slot P: none)."""
    P = m.capacity_pt
    has = (m.kf_obs_pt >= 0) & m.kf_kp_valid & m.kf_valid[:, None]
    flat = torch.where(has, m.kf_obs_pt, P).reshape(-1).long()
    return torch.zeros(P + 1, dtype=torch.float32, device=flat.device).index_add(
        0, flat, torch.ones(flat.shape, dtype=torch.float32, device=flat.device))


def cull_map_points(m: MapState, current_kf, min_kf_obs: float = 3.0) -> MapState:
    """MapPointCulling: invalidate points whose found/visible ratio is below
    0.25 (after 4 sightings), or that two keyframes after creation are seen
    by fewer than `min_kf_obs` keyframes; their observations are detached."""
    ratio = m.pt_found / torch.clamp(m.pt_visible, min=1.0)
    cnt = _observation_counts(m)[:m.capacity_pt]
    age = current_kf - m.pt_first_kf
    bad = m.pt_valid & (((ratio < 0.25) & (m.pt_visible >= 4.0)) | ((age >= 2) & (cnt < min_kf_obs)))
    obs = m.kf_obs_pt
    obs_bad = bad[obs.clamp(min=0).long()] & (obs >= 0)
    return m._replace(pt_valid=m.pt_valid & ~bad, kf_obs_pt=torch.where(obs_bad, -1, obs))


def _fuse_pair_match(cam: PinholeCamera, m: MapState, cnt, src, dst, inv_sigma2_table,
                     scale_factor: float = 1.2, n_levels: int = 8):
    """The match phase of SearchInNeighbors / ORBmatcher::Fuse for directed
    keyframe pairs src -> dst ((C,) tensors, C pairs at once): project src's
    map points into dst and match them against dst's keypoints. A pure read;
    mapping_front applies the merges and additions of all pairs at once.

    cnt (P,) holds each point's observation count (merge arbitration).
    Returns (tgt_slot, add, merge, winner, loser), each (C, N)."""
    src, dst = src.long(), dst.long()
    obs_a = m.kf_obs_pt[src]
    p_src = obs_a.clamp(min=0)
    pl = p_src.long()
    has_a = (obs_a >= 0) & m.kf_kp_valid[src] & m.pt_valid[pl]
    pts = m.pt_xyz[pl]
    R, t = m.kf_R[dst], m.kf_t[dst]
    p_cam = se3_apply(R, t[:, None], pts)
    uv = project(cam, p_cam)
    C = -(R.transpose(-1, -2) @ t[..., None])[..., 0]
    dist = torch.linalg.norm(pts - C[:, None], dim=-1)
    proj_ok = has_a & (p_cam[..., 2] > 0.05) & _in_image(cam, uv)
    pred_lvl = predict_scale(dist, m.pt_max_dist[pl], scale_factor, n_levels)
    idx, _, ok = search_by_projection_points(
        uv, m.pt_desc[pl], proj_ok, 3.0 * sf_pow(scale_factor, pred_lvl),
        torch.clamp(pred_lvl - 1, min=0), pred_lvl + 1,
        m.kf_kp_xy[dst], m.kf_kp_desc[dst], m.kf_kp_level[dst], m.kf_kp_angle[dst],
        m.kf_kp_valid[dst], max_dist=TH_LOW, nn_ratio=0.0,
    )
    q = torch.gather(m.kf_obs_pt[dst], 1, idx)  # the point already at the matched slot
    ok = ok & (q != p_src)
    qs = q.clamp(min=0)
    merge = ok & (q >= 0) & m.pt_valid[qs.long()]
    add = ok & ~merge
    # Strict (count, index) arbitration keeps the merge graph acyclic: the
    # more observed point wins (MapPoint::Replace), the lower index on a tie.
    c_src, c_q = cnt[pl], cnt[qs.long()]
    keep_src = (c_src > c_q) | ((c_src == c_q) & (p_src <= qs))
    return idx, add, merge, torch.where(keep_src, p_src, qs), torch.where(keep_src, qs, p_src)


def cull_keyframes(m: MapState, current_kf, protect: torch.Tensor):
    """KeyFrameCulling: invalidate unprotected keyframes whose observed
    points are >= 90% redundant (each seen by at least 3 other keyframes).
    A culled keyframe keeps its pose, detaches its observations and records
    its most covisible surviving keyframe (else the nearest surviving slot)
    as parent, with the relative pose T_k T_parent^-1. Returns (map, culled)."""
    K, N = m.kf_obs_pt.shape
    P = m.capacity_pt
    dev = m.kf_R.device
    has = (m.kf_obs_pt >= 0) & m.kf_kp_valid & m.kf_valid[:, None]
    cnt = _observation_counts(m)
    obs_cnt = cnt[torch.clamp(m.kf_obs_pt, max=P).long()]
    redundant = has & (obs_cnt >= 4.0)  # itself and 3 others
    n_obs = has.sum(dim=1).to(torch.float32)
    n_red = redundant.sum(dim=1).to(torch.float32)
    cull = m.kf_valid & ~protect & (n_obs > 0) & (n_red >= 0.9 * n_obs)
    survive = m.kf_valid & ~cull

    shared = torch.where(survive[None, :], covisibility_weights(m), -1.0)
    shared = shared - torch.diag(torch.diag(shared))
    idx = torch.arange(K, device=dev)
    nearness = -torch.abs(idx[:, None] - idx[None, :]).to(torch.float32)
    nearness = torch.where(survive[None, :] & (idx[None, :] != idx[:, None]), nearness, float("-inf"))
    parent = torch.where(shared.max(dim=1).values > 0, torch.argmax(shared, dim=1),
                         torch.argmax(nearness, dim=1))
    rel_R = m.kf_R @ m.kf_R[parent].transpose(-1, -2)
    rel_t = m.kf_t - torch.einsum("kij,kj->ki", rel_R, m.kf_t[parent])
    return m._replace(
        kf_valid=survive,
        kf_obs_pt=torch.where(cull[:, None], -1, m.kf_obs_pt),
        kf_parent=torch.where(cull, parent.to(torch.int32), m.kf_parent),
        kf_rel_R=torch.where(cull[:, None, None], rel_R, m.kf_rel_R),
        kf_rel_t=torch.where(cull[:, None], rel_t, m.kf_rel_t),
    ), cull


def _top_covis(rows: torch.Tensor, fids: torch.Tensor, anchors: torch.Tensor, n: int) -> torch.Tensor:
    """For each anchor keyframe ((Q,) tensor) with its (Q, K) covisibility
    row, the ids of its n most covisible keyframes (ties to the lower id),
    -1 where the weight is 0; with no covisible keyframe at all, its n
    newest by frame id. (Q, n) int64."""
    a = anchors.long()[:, None]
    tv, ti = _stable_topk(rows.scatter(1, a, 0.0), n)
    covis = torch.where(tv > 0, ti, -1)
    rv, ri = _stable_topk(fids.expand(a.shape[0], -1).scatter(1, a, -1), n)
    recent = torch.where(rv >= 0, ri, -1)
    return torch.where((tv > 0).any(dim=1, keepdim=True), covis, recent)


def best_covisible_ids(m: MapState, anchor, n: int) -> torch.Tensor:
    """The ids of keyframe `anchor`'s (a host int or a 1-element index
    tensor) n most covisible keyframes, -1 padded
    (KeyFrame::GetBestCovisibilityKeyFrames); the n newest by frame id when
    it has no covisible keyframe. (n,) int64."""
    n = min(n, m.kf_obs_pt.shape[0])
    shared = torch.where(m.kf_valid, shared_point_counts(m, anchor), 0.0)
    fids = torch.where(m.kf_valid, m.kf_frame_id, -1)
    if isinstance(anchor, torch.Tensor):
        anchors = anchor.reshape(1).long()
    else:
        anchors = torch.full((1,), anchor, dtype=torch.int64, device=shared.device)
    return _top_covis(shared[None], fids, anchors, n)[0]


def dedupe_fuse_targets(ext: torch.Tensor, K: int, nn_fuse: int) -> torch.Tensor:
    """Dedupe the two-hop fuse-target list ([direct targets (nn_fuse) | hop
    neighbours], ids in [0, K) or -1) and compact it, direct targets first,
    into at most 2 * nn_fuse entries (the JAX package's static cost cap),
    -1 padded."""
    L = ext.shape[0]
    dev = ext.device
    park = torch.where(ext >= 0, ext, K).long()  # -1 parks at K, past every id
    prio = torch.where(ext >= 0, 1, 0)
    prio = torch.where(torch.arange(L, device=dev) < nn_fuse, 2 * prio, prio)
    rank = torch.arange(L, 0, -1, dtype=torch.int64, device=dev)  # earlier is larger
    first = torch.zeros(K + 1, dtype=torch.int64, device=dev).scatter_reduce(
        0, park, rank, reduce="amax", include_self=True)
    prio = torch.where(first[park] == rank, prio, 0)
    order = torch.argsort(-prio, stable=True)[: 2 * nn_fuse]
    return torch.where(prio[order] > 0, ext[order], -1)


def _mark_max(mask: torch.Tensor, idx: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """mask.at[idx].max(val) for a bool mask."""
    return mask.to(torch.uint8).scatter_reduce(
        0, idx.long(), val.to(torch.uint8), reduce="amax", include_self=True).bool()


_PAIRS_PER_CHUNK = 4  # keyframe pairs matched at once: (4, N, N) planes

# The map fields each LocalMapping segment reads (the copy-in moves these
# and no others); each segment returns only the fields it changes.
MAP_HEAD_FIELDS = ("kf_obs_pt", "kf_kp_valid", "kf_valid", "kf_frame_id", "pt_valid", "pt_xyz")
TRI_MAP_FIELDS = ("kf_R", "kf_t", "kf_obs_pt", "kf_kp_valid", "kf_kp_xy", "kf_kp_level", "kf_kp_desc",
                  "kf_kp_angle", "pt_xyz")
INSERT_MAP_FIELDS = ("kf_obs_pt", "kf_kp_valid", "kf_valid", "kf_kp_desc", "pt_xyz", "pt_valid", "pt_desc",
                     "pt_normal", "pt_min_dist", "pt_max_dist", "pt_ref_kf", "pt_first_kf", "pt_found",
                     "pt_visible", "n_pt")
FUSE_MAP_FIELDS = ("kf_R", "kf_t", "kf_obs_pt", "kf_kp_valid", "kf_kp_xy", "kf_kp_level", "kf_kp_desc",
                   "kf_kp_angle", "pt_valid", "pt_xyz", "pt_desc", "pt_max_dist")
FUSE_APPLY_FIELDS = ("kf_obs_pt", "pt_valid", "pt_xyz")
TAIL_MAP_FIELDS = ("kf_R", "kf_t", "kf_valid", "kf_frame_id", "kf_obs_pt", "kf_kp_valid", "kf_kp_desc",
                   "kf_parent", "kf_rel_R", "kf_rel_t", "pt_xyz", "pt_valid", "pt_desc")
# What insert_points changes (the point arrays, the watermark).
POINT_FIELDS = ("pt_xyz", "pt_valid", "pt_desc", "pt_normal", "pt_min_dist", "pt_max_dist", "pt_ref_kf",
                "pt_first_kf", "pt_found", "pt_visible", "n_pt")


def merge_fields(m: MapState, part: MapState) -> MapState:
    """m with the fields that `part` holds (a segment's changed fields)."""
    return m._replace(**{k: v for k, v in part._asdict().items() if v is not None})


def map_head_segment(m: MapState, ki, *, nn_tri: int, nn_fuse: int, fuse_hop: int):
    """The LocalMapping epoch's head, as a segment: covisibility at the
    epoch's start, keyframe `ki`'s (a 1-element index tensor) neighbour
    list and its deduped two-hop fuse list. Returns (neighbours, ids first
    and -1 after, padded with -1 to whole chunks; the directed fuse pairs
    (max_pairs, 2), ki -> each fuse target, then each target -> ki, -1
    after; counts (2,): the lengths of both lists, for the host; the
    triangulation's running state before any chunk; the fusion's before
    any chunk)."""
    K, N = m.kf_obs_pt.shape
    dev = m.kf_obs_pt.device
    W = covisibility_weights(m)
    W = torch.where(m.kf_valid[None, :] & m.kf_valid[:, None], W, 0.0)
    fids = torch.where(m.kf_valid, m.kf_frame_id, -1)
    ki = ki.reshape(1).long()

    def top_covis(anchors, n):
        return _top_covis(W[anchors.long()], fids, anchors, n)

    neighbors = top_covis(ki, min(nn_tri, K))[0]
    targets = top_covis(ki, min(nn_fuse, K))[0]
    if fuse_hop > 0:
        hops = torch.where(targets[:, None] >= 0, top_covis(targets.clamp(min=0), min(fuse_hop, K)), -1)
        ext = torch.cat([targets, hops.reshape(-1)])
    else:
        ext = targets
    ext = torch.where(ext == ki, -1, ext)
    if fuse_hop > 0:
        ext = dedupe_fuse_targets(ext, K, nn_fuse)
    counts = torch.stack([(neighbors >= 0).sum(), (ext >= 0).sum()])

    c = _PAIRS_PER_CHUNK
    nbs = torch.cat([neighbors, neighbors.new_full((-neighbors.shape[0] % c,), -1)])
    L = ext.shape[0]
    max_pairs = 2 * L + (-2 * L) % c
    r = torch.arange(max_pairs, device=dev)
    n_ext = counts[1]
    fwd, back = r < n_ext, (r >= n_ext) & (r < 2 * n_ext)
    other = torch.where(fwd, ext[r.clamp(max=L - 1)], torch.where(back, ext[(r - n_ext).clamp(0, L - 1)], -1))
    own = torch.where(fwd | back, ki, -1)
    pairs = torch.stack([torch.where(fwd, own, other), torch.where(fwd, other, own)], 1)

    tri = (torch.zeros(N, dtype=torch.bool, device=dev), torch.zeros((N, 3), device=dev),
           torch.zeros((N, 3), device=dev), torch.zeros(N, device=dev), torch.zeros(N, device=dev),
           torch.zeros(N, dtype=torch.int32, device=dev), torch.zeros(N, dtype=torch.int64, device=dev))
    fused = (torch.full((max_pairs, N), K * N, dtype=torch.int64, device=dev),
             torch.zeros((max_pairs, N), dtype=torch.bool, device=dev),
             torch.zeros((max_pairs, N), dtype=torch.int32, device=dev),
             torch.zeros((max_pairs, N), dtype=torch.int32, device=dev),
             torch.full((max_pairs, N), -1, dtype=torch.int32, device=dev))
    return nbs, pairs, counts, tri, fused


def tri_chunk_segment(cam: PinholeCamera, m: MapState, ki, kf_old, tri, inv_sigma2_table, *,
                      scale_factor: float, n_levels: int):
    """One chunk of CreateNewMapPoints as a segment: keyframe ki against the
    neighbours kf_old ((4,), -1 rows masked), folded into the running state
    tri = (taken (N,), xyz, normal, min_d, max_d, the old keyframe's slot,
    the neighbour id): a keypoint not yet taken takes the first good
    neighbour of this chunk, so across chunks each keypoint holds its first
    good neighbour in list order."""
    have, xyz, nvec, mind, maxd, slot_old, nb = tri
    N = m.kf_obs_pt.shape[1]
    cols = torch.arange(N, device=kf_old.device)
    X, _, nv, mn, mx, _, so, good = triangulate_new_points(
        cam, m, ki, kf_old.clamp(min=0), inv_sigma2_table, scale_factor=scale_factor, n_levels=n_levels)
    good = good & (kf_old >= 0)[:, None]
    first = good.to(torch.uint8).argmax(dim=0)  # the chunk's first good neighbour
    take = good.any(dim=0) & ~have
    t3 = take[:, None]
    return (have | take, torch.where(t3, X[first, cols], xyz), torch.where(t3, nv[first, cols], nvec),
            torch.where(take, mn[first, cols], mind), torch.where(take, mx[first, cols], maxd),
            torch.where(take, so[first, cols], slot_old), torch.where(take, kf_old[first], nb))


def insert_cull_segment(m: MapState, ki, tri, *, min_kf_obs: float):
    """The triangulated points inserted (each observed by keyframe ki and by
    its neighbour), then recent-point culling (MapPointCulling), as a
    segment. Returns (the changed fields: points, watermark, observation
    table; each point's observation count (P,) after the culling, for
    fusion's merge arbitration)."""
    have, xyz, nvec, mind, maxd, slot_old, nb = tri
    K, N = m.kf_obs_pt.shape
    cols = torch.arange(N, device=xyz.device)
    m, slots = insert_points(m, xyz, _row(m.kf_kp_desc, ki), ki, have, nvec, mind, maxd)
    created = have & (slots >= 0)
    flat_obs = torch.cat([m.kf_obs_pt.reshape(-1), m.kf_obs_pt.new_zeros(1)])
    val = torch.where(created, slots, 0)
    flat_obs = scatter_last(flat_obs, torch.where(created, ki * N + cols, K * N), val)
    flat_obs = scatter_last(flat_obs, torch.where(created, nb * N + slot_old, K * N), val)
    m = cull_map_points(m._replace(kf_obs_pt=flat_obs[: K * N].reshape(K, N)), ki, min_kf_obs)
    return map_fields(m, POINT_FIELDS + ("kf_obs_pt",)), _observation_counts(m)[:m.capacity_pt]


def fuse_chunk_segment(cam: PinholeCamera, m: MapState, cnt, pairs, fused, inv_sigma2_table, *,
                       scale_factor: float, n_levels: int):
    """The match phase of SearchInNeighbors for 4 directed pairs ((4, 2)
    src -> dst, -1 rows masked), as a segment. `fused` holds the earlier
    chunks' rows, each (max_pairs, N): the flat observation index of each
    added observation (K*N where none), merge, winner, loser, and the
    source keyframe's observation row. This chunk's 4 rows are appended
    and the 4 oldest dropped, so after the last chunk the pairs' rows are
    in list order behind rows that add and merge nothing."""
    K, N = m.kf_obs_pt.shape
    ok = (pairs[:, 0] >= 0)[:, None]
    src, dst = pairs[:, 0].clamp(min=0), pairs[:, 1].clamp(min=0)
    tgt_slot, add, merge, winner, loser = _fuse_pair_match(
        cam, m, cnt, src, dst, inv_sigma2_table, scale_factor=scale_factor, n_levels=n_levels)
    rows = (torch.where(add & ok, dst[:, None] * N + tgt_slot, K * N), merge & ok, winner, loser,
            m.kf_obs_pt[src])
    c = pairs.shape[0]
    return tuple(torch.cat([f[c:], x]) for f, x in zip(fused, rows))


def fuse_apply_segment(m: MapState, fused):
    """Fusion's merges and additions of every pair at once, as a segment:
    one merge map (the last pair wins a conflict; the (count, index) order
    keeps chains acyclic, collapsed by pointer jumping) and one scatter of
    the added observations. Returns the changed fields (observation table,
    point validity)."""
    flat_idx, merge, winner, loser, src_obs = fused
    K, N = m.kf_obs_pt.shape
    P = m.capacity_pt
    dev = flat_idx.device
    merge_f = merge.reshape(-1)
    repl = scatter_last(torch.arange(P + 1, device=dev), torch.where(merge_f, loser.reshape(-1), P),
                        torch.where(merge_f, winner.reshape(-1), P).long())
    for _ in range(3):  # pointer jumping: chains up to depth 8
        repl = repl[repl]
    repl = repl[:P]
    obs = m.kf_obs_pt
    obs = torch.where(obs >= 0, repl[obs.clamp(min=0).long()].to(obs.dtype), obs)
    pt_valid = m.pt_valid & (repl == torch.arange(P, device=dev))
    # Observations for the matched free keypoints of every pair at once.
    val = repl[src_obs.clamp(min=0).long()].to(obs.dtype).reshape(-1)
    obs_flat = scatter_last(torch.cat([obs.reshape(-1), obs.new_zeros(1)]), flat_idx.reshape(-1), val)
    return map_fields(m._replace(kf_obs_pt=obs_flat[: K * N].reshape(K, N), pt_valid=pt_valid),
                      ("kf_obs_pt", "pt_valid"))


def map_tail_segment(m: MapState, ki, *, window: int):
    """The epoch's tail, as a segment: the representative descriptors of
    keyframe ki's points, then redundant-keyframe culling (KeyFrameCulling)
    protecting keyframes 0 and 1, ki, and the `window` newest and most
    covisible. Returns the changed fields."""
    K, N = m.kf_obs_pt.shape
    P = m.capacity_pt
    dev = m.kf_obs_pt.device
    cur = _row(m.kf_obs_pt, ki)
    touched = torch.zeros(P + 1, dtype=torch.bool, device=dev).index_fill(
        0, torch.where(cur >= 0, cur, P).long(), True)[:P]
    m = compute_point_descriptors(m, touched)
    w = min(window, K)
    idx = torch.arange(K, device=dev)
    protect = (idx == 0) | (idx == 1) | (idx == ki)
    rv, ri = _stable_topk(torch.where(m.kf_valid, m.kf_frame_id, -1), w)
    protect = _mark_max(protect, torch.where(rv >= 0, ri, 0), rv >= 0)
    cov = best_covisible_ids(m, ki, w)
    protect = _mark_max(protect, cov.clamp(min=0), cov >= 0)
    m, _ = cull_keyframes(m, ki, protect)
    return map_fields(m, ("pt_desc", "kf_valid", "kf_obs_pt", "kf_parent", "kf_rel_R", "kf_rel_t"))


def compose_mapping_front(run, cam: PinholeCamera, m: MapState, ki, inv_sigma2_table, min_kf_obs: float,
                          *, scale_factor: float, n_levels: int, nn_tri: int, nn_fuse: int,
                          fuse_hop: int, window: int) -> MapState:
    """The LocalMapping epoch for new keyframe `ki` (a host int or a
    1-element index tensor), each segment through `run(name, fn, static,
    **tensors)` (call_segment, or StepGraphs.run), in LocalMapping::Run's
    order:

      map_head: the covisibility at the epoch's start, the neighbour list
         and the deduped two-hop fuse list;
      map_tri, once per 4 neighbours: triangulation (CreateNewMapPoints);
         each keypoint takes the first good neighbour in list order, as a
         new point there removes the keypoint from the later neighbours'
         search;
      map_insert: the new points inserted, recent-point culling
         (MapPointCulling);
      map_fuse, once per 4 directed pairs, then map_fuse_apply: fusion in
         both directions (SearchInNeighbors), every pair matched against
         one state, then one merge map and one scatter of the added
         observations;
      map_tail: the representative descriptors of the new keyframe's
         points, redundant-keyframe culling (KeyFrameCulling).

    Both lists' lengths are read to the host after the head (the one
    device->host read), so that only the chunks holding pairs run: the JAX
    package runs every slot of its static lists and disables the empty
    ones, which changes nothing else. The chunks' last rows are padded and
    masked, so every segment has one key whatever ki and the lengths."""
    dev = m.kf_obs_pt.device
    if not isinstance(ki, torch.Tensor):
        ki = torch.full((1,), int(ki), dtype=torch.int64, device=dev)
    nbs, pairs, counts, tri, fused = run(
        "map_head", map_head_segment, dict(nn_tri=nn_tri, nn_fuse=nn_fuse, fuse_hop=fuse_hop),
        m=map_fields(m, MAP_HEAD_FIELDS), ki=ki)
    with traced("read.map_lengths"):
        n_nb, n_ext = (int(n) for n in counts.cpu())  # the one read
    c = _PAIRS_PER_CHUNK
    geo = dict(cam=cam, scale_factor=scale_factor, n_levels=n_levels)
    for i in range(0, n_nb, c):
        tri = run("map_tri", tri_chunk_segment, geo, m=map_fields(m, TRI_MAP_FIELDS), ki=ki,
                  kf_old=nbs[i:i + c], tri=tri, inv_sigma2_table=inv_sigma2_table)
    part, cnt = run("map_insert", insert_cull_segment, dict(min_kf_obs=float(min_kf_obs)),
                    m=map_fields(m, INSERT_MAP_FIELDS), ki=ki, tri=tri)
    m = merge_fields(m, part)
    for i in range(0, 2 * n_ext, c):
        fused = run("map_fuse", fuse_chunk_segment, geo, m=map_fields(m, FUSE_MAP_FIELDS), cnt=cnt,
                    pairs=pairs[i:i + c], fused=fused, inv_sigma2_table=inv_sigma2_table)
    m = merge_fields(m, run("map_fuse_apply", fuse_apply_segment, {}, m=map_fields(m, FUSE_APPLY_FIELDS),
                            fused=fused))
    return merge_fields(m, run("map_tail", map_tail_segment, dict(window=window),
                               m=map_fields(m, TAIL_MAP_FIELDS), ki=ki))


def mapping_front(cam: PinholeCamera, m: MapState, ki, inv_sigma2_table, min_kf_obs: float, *,
                  scale_factor: float, n_levels: int, nn_tri: int, nn_fuse: int, fuse_hop: int,
                  window: int, run=call_segment) -> MapState:
    """The LocalMapping epoch for new keyframe `ki`: compose_mapping_front's
    segments through `run` (eagerly by default; the tracker's
    map_graphs.run replays them)."""
    return compose_mapping_front(run, cam, m, ki, inv_sigma2_table, min_kf_obs,
                                 scale_factor=scale_factor, n_levels=n_levels, nn_tri=nn_tri,
                                 nn_fuse=nn_fuse, fuse_hop=fuse_hop, window=window)


# ---------------------------------------------------------------------------
# Keyframe insertion, the normals and point compaction as segments.
# ---------------------------------------------------------------------------

KF_INSERT_FIELDS = ("kf_R", "kf_t", "kf_valid", "kf_frame_id", "kf_kp_xy", "kf_kp_level", "kf_kp_angle",
                    "kf_kp_desc", "kf_kp_valid", "kf_kp_uright", "kf_obs_pt", "kf_parent", "n_kf")
NORMALS_FIELDS = ("kf_R", "kf_t", "kf_valid", "kf_obs_pt", "kf_kp_valid", "kf_kp_level", "pt_xyz",
                  "pt_valid", "pt_ref_kf", "pt_normal", "pt_min_dist", "pt_max_dist")
NORMALS_CHANGED = ("pt_normal", "pt_min_dist", "pt_max_dist")
COMPACT_FIELDS = POINT_FIELDS[:-1] + ("kf_obs_pt",)


def point_ranges(scale_factors: torch.Tensor, dist: torch.Tensor, level: torch.Tensor):
    """MapPoint::UpdateNormalAndDepth's scale-invariance range (the
    creation's 0.8 / 1.2 margins applied) at distance `dist` seen at octave
    `level`; scale_factors (n_levels,)."""
    sf = scale_factors[torch.clamp(level, 0, scale_factors.shape[0] - 1).long()]
    max_d = dist * sf
    min_d = max_d / scale_factors[-1]
    return 0.8 * min_d, 1.2 * max_d


def add_depth_points(cam: PinholeCamera, m: MapState, ki, feats: FrameFeatures, R, t,
                     th_depth: float, scale_factors: torch.Tensor) -> MapState:
    """Tracking::CreateNewKeyFrame's densification: a map point for each of
    keyframe ki's (a host int or a 1-element index tensor) untracked
    keypoints closer than th_depth."""
    obs_kf = _row(m.kf_obs_pt, ki)
    d = feats.depth
    free = (obs_kf < 0) & feats.valid & (d > 0) & (d < th_depth)
    Xc = unproject(cam, feats.xy, d)
    Xw = se3_apply(*se3_inverse(R, t), Xc)
    vecs = Xw - (-(R.T @ t))
    normal = vecs / torch.clamp(torch.linalg.norm(vecs, dim=-1, keepdim=True), min=1e-9)
    lo, hi = point_ranges(scale_factors, torch.linalg.norm(Xc, dim=-1), feats.level)
    m, slots = insert_points(m, Xw, feats.desc, ki, free, normal, lo, hi)
    new_obs = torch.where(free & (slots >= 0), slots, obs_kf).to(m.kf_obs_pt.dtype)
    row = ki.reshape(1).long() if isinstance(ki, torch.Tensor) else torch.full(
        (1,), ki, dtype=torch.int64, device=new_obs.device)
    return m._replace(kf_obs_pt=m.kf_obs_pt.index_put((row,), new_obs[None]))


def kf_insert_segment(cam: PinholeCamera, m: MapState, feats: FrameFeatures, R, t, frame_id, obs, ki,
                      scale_factors, *, recycled: bool, depth: bool, th_depth: float) -> MapState:
    """Keyframe insertion as a segment: the keyframe at the watermark, or
    with `recycled` at slot ki (the watermark kept), frame_id and ki
    1-element tensors; for a depth sensor its close untracked keypoints as
    new points (add_depth_points). Returns the changed fields."""
    m, _ = insert_keyframe(m, feats, R, t, frame_id, obs, slot=ki if recycled else None)
    if not depth:
        return map_fields(m, KF_INSERT_FIELDS)
    m = add_depth_points(cam, m, ki, feats, R, t, th_depth, scale_factors)
    return map_fields(m, KF_INSERT_FIELDS + POINT_FIELDS)


def normals_segment(m: MapState, scale_factors) -> MapState:
    """update_point_normals as a segment: the changed fields."""
    return map_fields(update_point_normals(m, scale_factors), NORMALS_CHANGED)


def compact_segment(m: MapState):
    """compact_point_slots as a segment: (the changed fields, old_to_new)."""
    m, old_to_new = compact_point_slots(m)
    return map_fields(m, POINT_FIELDS + ("kf_obs_pt",)), old_to_new
