"""Batched ORB matching search modes. Port of tpuslam/matching/search.py.

Every function takes arbitrary leading batch dims (one per camera stream):
a search is one dense masked all-pairs problem per stream.
"""

from __future__ import annotations

import math

import torch

from tpuslam_torch.matching.hamming import hamming_matrix
from tpuslam_torch.pipeline._index import sf_pow

TH_HIGH = 100
TH_LOW = 50
HISTO_LENGTH = 30
_BIG = 1 << 20  # sentinel distance for masked pairs


def _best_two(dist: torch.Tensor):
    """Per-row best and second best over (..., Nq, Nc): (d1, i1, d2, masked)
    where i1 is the first minimal index (as jnp.argmin) and masked is dist
    with each row's best set to the sentinel, for the second-best's index."""
    i1 = torch.argmin(dist, dim=-1)
    d1 = torch.gather(dist, -1, i1[..., None])[..., 0]
    masked = dist.scatter(-1, i1[..., None], _BIG)
    return d1, i1, masked.amin(dim=-1), masked


def resolve_duplicates(idx, dist, valid, n_targets: int):
    """One-to-one: of the queries matching one target keep the lowest
    distance, ties to the lowest query index. (..., Nq) in, mask out."""
    tgt = torch.where(valid, idx, torch.full_like(idx, n_targets))
    lead = idx.shape[:-1]
    best = torch.full((*lead, n_targets + 1), _BIG, dtype=dist.dtype, device=dist.device)
    best = best.scatter_reduce(
        -1, tgt, torch.where(valid, dist, torch.full_like(dist, _BIG)), reduce="amin"
    )
    is_best = valid & (dist == torch.gather(best, -1, tgt))
    qidx = torch.arange(idx.shape[-1], device=idx.device).expand(idx.shape)
    first_q = torch.full((*lead, n_targets + 1), 1 << 30, dtype=torch.int64, device=idx.device)
    first_q = first_q.scatter_reduce(
        -1, tgt, torch.where(is_best, qidx, torch.full_like(qidx, 1 << 30)), reduce="amin"
    )
    return is_best & (torch.gather(first_q, -1, tgt) == qidx)


def rotation_consistency_mask(angle_q, angle_t, valid):
    """Keep only matches whose rotation offset falls in the 3 dominant bins
    of a 30-bin histogram, with the 0.1x dominance rule that drops weak
    second and third bins (ORBmatcher::ComputeThreeMaxima).

    angle_q, angle_t, valid: (..., N), radians for the two sides of each
    match. The offset is taken with floor modulo (torch.remainder), as
    jnp.mod does; torch.round is half-to-even, as jnp.round is."""
    two_pi = 2.0 * math.pi
    rot = torch.remainder(angle_q - angle_t, two_pi)
    b = torch.round(rot * (HISTO_LENGTH / two_pi)).to(torch.int64) % HISTO_LENGTH
    onehot = (b[..., :, None] == torch.arange(HISTO_LENGTH, device=b.device)) & valid[..., :, None]
    hist = onehot.to(torch.int32).sum(dim=-2)  # (..., 30)
    top3 = torch.topk(hist, 3, dim=-1).values  # only the values: ties do not matter
    max1 = top3[..., 0]
    keep2 = top3[..., 1].to(torch.float32) > 0.1 * max1.to(torch.float32)
    keep3 = top3[..., 2].to(torch.float32) > 0.1 * max1.to(torch.float32)
    thresh = torch.where(keep3, top3[..., 2], torch.where(keep2, top3[..., 1], max1))
    good_bin = hist >= torch.clamp(thresh, min=1)[..., None]
    return valid & torch.gather(good_bin, -1, b)


def match_nn_ratio(desc_q, desc_t, pair_mask, max_dist: int = TH_LOW, nn_ratio: float = 0.9):
    """Best/second-best matching with the ratio test. desc_q (..., Nq, 8),
    desc_t (..., Nt, 8), pair_mask (..., Nq, Nt) of admissible pairs.
    Returns (idx, dist, valid), each (..., Nq). The ratio is strict (<):
    equal best and second-best distances are ambiguous and rejected."""
    dist = torch.where(pair_mask, hamming_matrix(desc_q, desc_t), _BIG)
    d1, i1, d2, _ = _best_two(dist)
    valid = (d1 <= max_dist) & (d1.to(torch.float32) < nn_ratio * d2.to(torch.float32))
    return i1, d1, valid


def search_for_initialization(xy1, desc1, level1, angle1, valid1,
                              xy2, desc2, level2, angle2, valid2,
                              window: float = 100.0, nn_ratio: float = 0.9,
                              check_rotation: bool = True):
    """Monocular-initialization matching (ORBmatcher::SearchForInitialization):
    level-0 keypoints only, windowed around the frame-1 location, NN ratio,
    one-to-one, rotation-consistency filter. Returns (idx2, dist, valid),
    each (..., N1)."""
    pair = (
        valid1[..., :, None] & valid2[..., None, :]
        & (level1[..., :, None] == 0) & (level2[..., None, :] == 0)
        & (torch.abs(xy1[..., :, None, 0] - xy2[..., None, :, 0]) < window)
        & (torch.abs(xy1[..., :, None, 1] - xy2[..., None, :, 1]) < window)
    )
    idx, dist, valid = match_nn_ratio(desc1, desc2, pair, TH_LOW, nn_ratio)
    valid = resolve_duplicates(idx, dist, valid, xy2.shape[-2])
    if check_rotation:
        valid = rotation_consistency_mask(angle1, torch.gather(angle2, -1, idx), valid)
    return idx, dist, valid


def search_by_projection_points(
    uv_proj, pt_desc, pt_valid, radius, level_lo, level_hi,
    kp_xy, kp_desc, kp_level, kp_angle, kp_valid,
    max_dist: int = TH_HIGH, nn_ratio: float = 0.0, ratio_same_level_only: bool = True,
):
    """Match projected points (..., Np) against frame keypoints (..., Nk)
    inside a per-point square window of `radius` px and octave window
    [level_lo, level_hi]. Returns (idx, dist, valid), each (..., Np)."""
    du = torch.abs(uv_proj[..., :, None, 0] - kp_xy[..., None, :, 0])
    dv = torch.abs(uv_proj[..., :, None, 1] - kp_xy[..., None, :, 1])
    r = radius[..., :, None]
    pair = (
        pt_valid[..., :, None] & kp_valid[..., None, :]
        & (du < r) & (dv < r)
        & (kp_level[..., None, :] >= level_lo[..., :, None])
        & (kp_level[..., None, :] <= level_hi[..., :, None])
    )
    dist = torch.where(pair, hamming_matrix(pt_desc, kp_desc), _BIG)
    d1, i1, d2, masked = _best_two(dist)
    valid = pt_valid & (d1 <= max_dist)
    if nn_ratio > 0.0:
        lvl1 = torch.gather(kp_level, -1, i1)
        lvl2 = torch.gather(kp_level, -1, torch.argmin(masked, dim=-1))
        ratio_fail = d1.to(torch.float32) > nn_ratio * d2.to(torch.float32)
        if ratio_same_level_only:
            ratio_fail &= lvl1 == lvl2
        valid &= ~ratio_fail
    valid = resolve_duplicates(i1, d1, valid, kp_xy.shape[-2])
    return i1, d1, valid


def search_by_projection_frame(uv_proj, proj_valid, last_level, last_desc, last_angle,
                               kp_xy, kp_desc, kp_level, kp_angle, kp_valid,
                               th: float = 7.0, scale_factor: float = 1.2,
                               check_rotation: bool = True):
    """Track-with-motion-model matching (ORBmatcher::SearchByProjection for
    the last frame): the last frame's points projected into the current
    frame, searched in a th x scale^octave window with the octave gate
    [oct-1, oct+1] and TH_HIGH, then the rotation-consistency filter.
    Returns (idx, dist, valid) over the last frame's points."""
    radius = th * sf_pow(scale_factor, last_level)
    idx, dist, valid = search_by_projection_points(
        uv_proj, last_desc, proj_valid, radius,
        torch.clamp(last_level - 1, min=0), last_level + 1,
        kp_xy, kp_desc, kp_level, kp_angle, kp_valid,
        max_dist=TH_HIGH, nn_ratio=0.0,
    )
    if check_rotation:
        valid = rotation_consistency_mask(last_angle, torch.gather(kp_angle, -1, idx), valid)
    return idx, dist, valid
