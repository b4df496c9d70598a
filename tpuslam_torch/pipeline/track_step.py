"""The per-frame monocular tracking hot path over B camera streams.

Port of the inner `step` of __graft_entry__.entry_batched, which bench.py
times and the real tracker runs each frame (steps.fused_track_frame_image):

  1. ORB extraction of all streams (FAST+NMS and patch-gather kernels),
  2. motion-model search against the last frame's points
     (ORBmatcher::SearchByProjection, th=7 window, octave gate),
  3. pose optimization #1 (4x10 LM),
  4. local-map search with the isInFrustum gates (frustum, distance range,
     viewing cosine, predicted scale, keypoints taken by stage 1 excluded),
  5. pose optimization #2 over the union of matches.

The JAX version vmaps stages 2 and 4 over streams; here every tensor keeps
its leading stream dim B. bench.py jits the step; here it is one segment
(track_step_segment, no host read), run through `run`: eagerly by
default, or StepGraphs.run (pipeline/graphs.py), which on a card replays
one CUDA graph per input-shape key.
"""

from __future__ import annotations

import functools

import torch

from tpuslam_torch.geometry.camera import PinholeCamera, project
from tpuslam_torch.geometry.se3 import se3_apply
from tpuslam_torch.matching.search import TH_HIGH, search_by_projection_points
from tpuslam_torch.ops.orb import ORBConfig, extract_orb_batched
from tpuslam_torch.optim.pose import PoseObs, pose_optimization
from tpuslam_torch.pipeline._index import gather_rows, scatter_last, sf_pow
from tpuslam_torch.pipeline.graphs import call_segment
from tpuslam_torch.pipeline.steps import predict_scale


@functools.lru_cache(maxsize=None)
def _inv_sigma2(n_levels: int, sf: float, device: torch.device) -> torch.Tensor:
    """1 / sigma^2 per octave on `device`, copied there once per setting
    (a capture refuses a host->device copy)."""
    return torch.tensor([1.0 / (sf**l) ** 2 for l in range(n_levels)], dtype=torch.float32,
                        device=device)


def track_step_batched(cam: PinholeCamera, cfg: ORBConfig, imgs,
                       last_xyz, last_desc, last_level, last_angle,
                       map_xyz, map_desc, map_normal, map_min_d, map_max_d, R0, t0,
                       run=call_segment):
    """One tracking step for B streams.

    imgs (B, H, W) float32 in [0, 255]; last_* (B, N, ...) the last frame's
    tracked points (world xyz, int32 descriptor words, octave, angle); map_*
    (B, L, ...) the local map (xyz, descriptors, viewing normal, distance
    range); R0 (B, 3, 3), t0 (B, 3) the predicted pose T_cw. `run` runs
    the step's one segment (StepGraphs.run replays its graph).
    Returns (R2 (B, 3, 3), t2 (B, 3), n_inl2 (B,), n_valid) where n_valid is
    the number of valid keypoints over all streams, a device scalar.
    """
    return run("batched", track_step_segment, dict(cam=cam, cfg=cfg), imgs=imgs,
               last_xyz=last_xyz, last_desc=last_desc, last_level=last_level,
               last_angle=last_angle, map_xyz=map_xyz, map_desc=map_desc, map_normal=map_normal,
               map_min_d=map_min_d, map_max_d=map_max_d, R0=R0, t0=t0,
               inv_sigma2=_inv_sigma2(cfg.n_levels, cfg.scale_factor, imgs.device))


def track_step_segment(imgs, last_xyz, last_desc, last_level, last_angle, map_xyz, map_desc,
                       map_normal, map_min_d, map_max_d, R0, t0, inv_sigma2, *,
                       cam: PinholeCamera, cfg: ORBConfig):
    """track_step_batched's body: tensors in, new tensors out, no host read
    (inv_sigma2 (n_levels,) the octaves' 1 / sigma^2)."""
    n_levels, sf = cfg.n_levels, cfg.scale_factor
    B = imgs.shape[0]
    dev = imgs.device
    feats = extract_orb_batched(imgs, cfg)
    Nk = feats.xy.shape[1]
    N = last_xyz.shape[1]

    def in_image(uv):
        return ((uv[..., 0] >= 0) & (uv[..., 0] < cam.width)
                & (uv[..., 1] >= 0) & (uv[..., 1] < cam.height))

    # ---- stage 1: motion-model search (Tracking.cc:919) -------------------
    p_cam = se3_apply(R0[:, None], t0[:, None], last_xyz)
    uv = project(cam, p_cam)
    valid = (p_cam[..., 2] > 0.05) & in_image(uv)
    idx1, _, ok1 = search_by_projection_points(
        uv, last_desc, valid, 7.0 * sf_pow(sf, last_level),
        torch.clamp(last_level - 1, min=0), last_level + 1,
        feats.xy, feats.desc, feats.level, feats.angle, feats.valid,
        max_dist=TH_HIGH, nn_ratio=0.0,
    )
    uvr1 = torch.cat(
        [gather_rows(feats.xy, idx1), -torch.ones((B, N, 1), device=dev)], dim=-1
    )
    obs1 = PoseObs(last_xyz, uvr1, torch.ones((B, N), device=dev), ok1)
    R1, t1, inl1, _ = pose_optimization(cam, R0, t0, obs1)

    # Keypoints claimed by stage 1 are excluded from the local-map search.
    o1 = ok1 & inl1
    kp_taken = scatter_last(torch.zeros((B, Nk), dtype=torch.bool, device=dev), idx1, o1)

    # ---- stage 2: local-map search with isInFrustum gates ------------------
    p_cam = se3_apply(R1[:, None], t1[:, None], map_xyz)
    uv = project(cam, p_cam)
    C = -(R1.transpose(-1, -2) @ t1[..., None])[..., 0]
    vec = map_xyz - C[:, None]
    dist = torch.linalg.norm(vec, dim=-1)
    in_range = (dist >= map_min_d) & (dist <= map_max_d)
    view_cos = torch.sum(vec * map_normal, dim=-1) / torch.clamp(
        dist * torch.linalg.norm(map_normal, dim=-1), min=1e-9
    )
    cand = (p_cam[..., 2] > 0.05) & in_image(uv) & in_range & (view_cos > 0.5)
    lvl = predict_scale(dist, map_max_d, sf, n_levels)
    radius = torch.where(
        view_cos > 0.998, torch.full_like(dist, 2.5), torch.full_like(dist, 4.0)
    ) * sf_pow(sf, lvl)
    idx2, _, ok2 = search_by_projection_points(
        uv, map_desc, cand, radius, torch.clamp(lvl - 1, min=0), lvl + 1,
        feats.xy, feats.desc, feats.level, feats.angle, feats.valid & ~kp_taken,
        max_dist=TH_HIGH, nn_ratio=0.8, ratio_same_level_only=True,
    )

    # ---- pose optimization #2 over the union (Tracking.cc:992) ------------
    # Per-keypoint observations: stage-1 world points where inliers, stage-2
    # matches on still-free keypoints.
    X = torch.zeros((B, Nk, 3), device=dev)
    has = torch.zeros((B, Nk), dtype=torch.bool, device=dev)
    X = scatter_last(X, idx1, torch.where(o1[..., None], last_xyz, gather_rows(X, idx1)))
    has = scatter_last(has, idx1, o1 | gather_rows(has, idx1))
    take2 = ok2 & gather_rows(~has, idx2)
    X = scatter_last(X, idx2, torch.where(take2[..., None], map_xyz, gather_rows(X, idx2)))
    has = scatter_last(has, idx2, take2 | gather_rows(has, idx2))

    uvr2 = torch.cat([feats.xy, -torch.ones((B, Nk, 1), device=dev)], dim=-1)
    inv_s2 = inv_sigma2[torch.clamp(feats.level, 0, n_levels - 1).long()]
    obs2 = PoseObs(X, uvr2, inv_s2, has & feats.valid)
    R2, t2, _, n_inl2 = pose_optimization(cam, R1, t1, obs2)
    return R2, t2, n_inl2, feats.valid.sum()
