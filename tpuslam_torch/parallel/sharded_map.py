"""Sharded map residency: the point arrays in contiguous blocks, one per
device of a mesh, the keyframe arrays replicated. Port of
tpuslam/parallel/sharded_map.py.

The map's large axis is the point capacity; keyframe state (poses,
keypoint and observation tables) is small next to it, and every shard
needs the observation table to find its own block's rows. What each
operation needs:

- covisibility (KeyFrame::UpdateConnections): the shared-point counts are
  a sum of per-block incidence products, added in shard order
  (`sharded_covisibility_weights`); each block's product is itself blocked
  as mapstate.core.covisibility_weights is, so no (K, P / n) incidence is
  formed;
- projection matching (TrackLocalMap): each shard projects and matches its
  own block against the replicated frame, with no communication
  (`sharded_search_local_points`);
- bundle adjustment: point-sharded in parallel/dist_ba.py.

A mesh is a list of torch devices (parallel/dist_ba.py::make_mesh).
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from tpuslam_torch.geometry.camera import PinholeCamera, project
from tpuslam_torch.geometry.se3 import se3_apply
from tpuslam_torch.mapstate.core import MapState
from tpuslam_torch.matching.search import search_by_projection_points

# MapState fields whose leading axis is the point capacity.
POINT_FIELDS = (
    "pt_xyz", "pt_valid", "pt_desc", "pt_normal", "pt_min_dist",
    "pt_max_dist", "pt_ref_kf", "pt_first_kf", "pt_found", "pt_visible",
)


def pad_point_capacity(m: MapState, multiple: int) -> MapState:
    """Grow the point capacity to a multiple of `multiple`; the new slots
    are zeros (invalid points)."""
    rem = (-m.capacity_pt) % multiple
    if rem == 0:
        return m
    return m._replace(**{f: torch.cat([getattr(m, f), getattr(m, f).new_zeros((rem, *getattr(m, f).shape[1:]))])
                         for f in POINT_FIELDS})


def shard_map_state(m: MapState, mesh: Sequence) -> List[MapState]:
    """The map placed on `mesh`: one MapState per shard on its device, the
    point fields its contiguous block of the (padded) capacity, every other
    field replicated."""
    mesh = [torch.device(d) for d in mesh]
    m = pad_point_capacity(m, len(mesh))
    blk = m.capacity_pt // len(mesh)
    return [MapState(**{f: (a[s * blk:(s + 1) * blk] if f in POINT_FIELDS else a).to(d)
                        for f, a in m._asdict().items()})
            for s, d in enumerate(mesh)]


def _block_covisibility(kf_obs_pt, kf_kp_valid, kf_valid, pt_valid_blk, lo: int, sub: int) -> torch.Tensor:
    """(K, K) shared-point counts over the points [lo, lo + blk) of one
    shard, their incidence formed `sub` points at a time."""
    K = kf_obs_pt.shape[0]
    blk = pt_valid_blk.shape[0]
    has = (kf_obs_pt >= 0) & kf_kp_valid & kf_valid[:, None]
    local = (kf_obs_pt - lo).long()
    mine = has & (local >= 0) & (local < blk)
    w = torch.zeros((K, K), dtype=torch.float32, device=kf_obs_pt.device)
    for off in range(0, blk, sub):
        n = min(sub, blk - off)
        in_sub = mine & (local >= off) & (local < off + n)
        col = torch.where(in_sub, local - off, n)
        inc = torch.zeros((K, n + 1), dtype=torch.float32, device=w.device)
        inc = torch.clamp(inc.scatter_add(1, col, in_sub.to(torch.float32))[:, :n], max=1.0)
        inc = inc * pt_valid_blk[off:off + n].to(torch.float32)[None, :]
        w = w + inc @ inc.T
    return w


def sharded_covisibility_weights(m: MapState, mesh: Sequence, block: int = 16384) -> torch.Tensor:
    """(K, K) covisibility weights (mapstate.core.covisibility_weights, the
    same integers) from one incidence product per point block, each on its
    shard's device, added in shard order on the first. Culled points do not
    count."""
    mesh = [torch.device(d) for d in mesh]
    m = pad_point_capacity(m, len(mesh))
    blk = m.capacity_pt // len(mesh)
    w = None
    for s, d in enumerate(mesh):
        part = _block_covisibility(m.kf_obs_pt.to(d), m.kf_kp_valid.to(d), m.kf_valid.to(d),
                                   m.pt_valid[s * blk:(s + 1) * blk].to(d), s * blk, block)
        w = part if w is None else w + part.to(w.device)
    return w - torch.diag(torch.diag(w))


def sharded_search_local_points(cam: PinholeCamera, m: MapState, mesh: Sequence, R: torch.Tensor,
                                t: torch.Tensor, kp_xy, kp_desc, kp_level, kp_angle, kp_valid,
                                radius_px: float = 15.0):
    """Every resident map point projected into the frame (R, t) and matched
    against its keypoints, each shard over its own point block with the
    frame replicated. Returns (idx (P,), dist (P,), ok (P,)) over the padded
    capacity, the blocks' outputs concatenated on the first shard's device:
    the dense single-device search's values."""
    mesh = [torch.device(d) for d in mesh]
    m = pad_point_capacity(m, len(mesh))
    blk = m.capacity_pt // len(mesh)
    outs = []
    for s, d in enumerate(mesh):
        p = slice(s * blk, (s + 1) * blk)
        pc = se3_apply(R.to(d), t.to(d), m.pt_xyz[p].to(d))
        uv = project(cam, pc)
        outs.append(search_by_projection_points(
            uv, m.pt_desc[p].to(d), m.pt_valid[p].to(d) & (pc[:, 2] > 0.1),
            torch.full((blk,), radius_px, device=d), torch.zeros(blk, dtype=torch.int32, device=d),
            torch.full((blk,), 7, dtype=torch.int32, device=d),
            kp_xy.to(d), kp_desc.to(d), kp_level.to(d), kp_angle.to(d), kp_valid.to(d)))
    d0 = mesh[0]
    return tuple(torch.cat([o[i].to(d0) for o in outs]) for i in range(3))
