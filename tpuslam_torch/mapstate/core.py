"""MapState: the SoA map and its update functions. Port of
tpuslam/mapstate/core.py.

Capacities are static and validity masks carve out the live set. The
keyframe observation table kf_obs_pt (K, N) maps each keypoint slot to a
map-point index (-1 = none); covisibility is derived from it on demand.

Every update returns a new MapState and leaves its input as it was, as the
JAX package does: a caller may keep an earlier state (a snapshot) while the
map moves on. Scatters follow the JAX package's rules: where an index
repeats the last write wins (pipeline/_index.py), so the parked rows of
insert_points behave as they do there. Device and dtypes come from the
map's tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpuslam_torch.matching.hamming import _popcount32, _words
from tpuslam_torch.pipeline._index import scatter_last, scatter_sum


class FrameFeatures(NamedTuple):
    """Per-frame keypoint arrays (capacity N): undistorted coords, octave,
    angle, descriptor, validity, stereo virtual-right coord (<0 = mono),
    depth (0 = unknown)."""

    xy: torch.Tensor       # (N, 2) float32
    level: torch.Tensor    # (N,) int32
    angle: torch.Tensor    # (N,) float32
    desc: torch.Tensor     # (N, 8) int32 bit patterns of uint32 words
    valid: torch.Tensor    # (N,) bool
    u_right: torch.Tensor  # (N,) float32
    depth: torch.Tensor    # (N,) float32


class MapState(NamedTuple):
    # Keyframes.
    kf_R: torch.Tensor         # (K, 3, 3) world->cam
    kf_t: torch.Tensor         # (K, 3)
    kf_valid: torch.Tensor     # (K,) bool
    kf_frame_id: torch.Tensor  # (K,) int32 source frame id
    kf_kp_xy: torch.Tensor     # (K, N, 2)
    kf_kp_level: torch.Tensor  # (K, N) int32
    kf_kp_angle: torch.Tensor  # (K, N)
    kf_kp_desc: torch.Tensor   # (K, N, 8) int32 bit patterns
    kf_kp_valid: torch.Tensor  # (K, N) bool
    kf_kp_uright: torch.Tensor # (K, N)
    kf_obs_pt: torch.Tensor    # (K, N) int32 point index or -1
    # Spanning tree of culled keyframes: pose relative to a surviving parent.
    kf_parent: torch.Tensor    # (K,) int32 parent of a culled kf, else -1
    kf_rel_R: torch.Tensor     # (K, 3, 3)
    kf_rel_t: torch.Tensor     # (K, 3)
    # Map points.
    pt_xyz: torch.Tensor       # (P, 3)
    pt_valid: torch.Tensor     # (P,) bool
    pt_desc: torch.Tensor      # (P, 8) int32 bit patterns
    pt_normal: torch.Tensor    # (P, 3)
    pt_min_dist: torch.Tensor  # (P,)
    pt_max_dist: torch.Tensor  # (P,)
    pt_ref_kf: torch.Tensor    # (P,) int32
    pt_first_kf: torch.Tensor  # (P,) int32 kf at creation
    pt_found: torch.Tensor     # (P,) float32 counters
    pt_visible: torch.Tensor   # (P,)
    # Watermarks.
    n_kf: torch.Tensor         # () int32
    n_pt: torch.Tensor         # () int32

    @property
    def capacity_kf(self) -> int:
        return self.kf_R.shape[0]

    @property
    def capacity_pt(self) -> int:
        return self.pt_xyz.shape[0]


def make_empty_map(max_kf: int, n_features: int, max_pt: int, device="cuda") -> MapState:
    K, N, P = max_kf, n_features, max_pt
    f32, i32 = torch.float32, torch.int32

    def full(shape, value, dtype=f32):
        return torch.full(shape, value, dtype=dtype, device=device)

    eye = torch.eye(3, dtype=f32, device=device).expand(K, 3, 3)
    return MapState(
        kf_R=eye.clone(),
        kf_t=full((K, 3), 0.0),
        kf_valid=full((K,), False, torch.bool),
        kf_frame_id=full((K,), 0, i32),
        kf_kp_xy=full((K, N, 2), 0.0),
        kf_kp_level=full((K, N), 0, i32),
        kf_kp_angle=full((K, N), 0.0),
        kf_kp_desc=full((K, N, 8), 0, i32),
        kf_kp_valid=full((K, N), False, torch.bool),
        kf_kp_uright=full((K, N), -1.0),
        kf_obs_pt=full((K, N), -1, i32),
        kf_parent=full((K,), -1, i32),
        kf_rel_R=eye.clone(),
        kf_rel_t=full((K, 3), 0.0),
        pt_xyz=full((P, 3), 0.0),
        pt_valid=full((P,), False, torch.bool),
        pt_desc=full((P, 8), 0, i32),
        pt_normal=full((P, 3), 0.0),
        pt_min_dist=full((P,), 0.0),
        pt_max_dist=full((P,), float("inf")),
        pt_ref_kf=full((P,), 0, i32),
        pt_first_kf=full((P,), 0, i32),
        pt_found=full((P,), 1.0),
        pt_visible=full((P,), 1.0),
        n_kf=full((), 0, i32),
        n_pt=full((), 0, i32),
    )


def _set_row(a: torch.Tensor, ki, value, full) -> torch.Tensor:
    """a with row ki set to value, unless full: a copy, with no host sync
    (ki and full may be device scalars)."""
    row = ki.reshape(1)  # a 1-d index: a 0-d tensor index would read it on the host
    if isinstance(value, torch.Tensor):  # a row, or a 1-element tensor for a 1-d array
        v = value.to(a.dtype).reshape(1, *a.shape[1:])
    else:  # a Python scalar: filled on the device, not copied from the host
        v = torch.full((1, *a.shape[1:]), value, dtype=a.dtype, device=a.device)
    return a.index_put((row,), torch.where(full, a.index_select(0, row), v))


def insert_keyframe(m: MapState, feats: FrameFeatures, R, t, frame_id,
                    obs_pt: torch.Tensor, slot=None):
    """Insert a keyframe at the next slot, or at an explicit recycled `slot`
    (the watermark then stays put). obs_pt: (N,) point index per keypoint
    (-1 none); frame_id and slot are host numbers or 1-element tensors (no
    host read). Returns (new_map, kf_index as a 0-d int64 tensor). A no-op
    when the map is full and no slot is given."""
    dev = m.kf_R.device
    if isinstance(slot, torch.Tensor):
        ki = slot.reshape(()).long()
        full = torch.zeros((), dtype=torch.bool, device=dev)
    elif slot is not None:
        ki = torch.full((), slot, dtype=torch.int64, device=dev)
        full = torch.zeros((), dtype=torch.bool, device=dev)
    else:
        full = m.n_kf >= m.capacity_kf
        ki = torch.clamp(m.n_kf, max=m.capacity_kf - 1).to(torch.int64)

    def s(a, v):
        return _set_row(a, ki, v, full)

    m = m._replace(
        kf_R=s(m.kf_R, R),
        kf_t=s(m.kf_t, t),
        kf_valid=s(m.kf_valid, True),
        kf_frame_id=s(m.kf_frame_id, frame_id),
        kf_kp_xy=s(m.kf_kp_xy, feats.xy),
        kf_kp_level=s(m.kf_kp_level, feats.level),
        kf_kp_angle=s(m.kf_kp_angle, feats.angle),
        kf_kp_desc=s(m.kf_kp_desc, feats.desc),
        kf_kp_valid=s(m.kf_kp_valid, feats.valid),
        kf_kp_uright=s(m.kf_kp_uright, feats.u_right),
        kf_obs_pt=s(m.kf_obs_pt, obs_pt),
        kf_parent=s(m.kf_parent, -1),
        n_kf=m.n_kf if slot is not None else torch.where(full, m.n_kf, m.n_kf + 1),
    )
    return m, ki


def insert_points(m: MapState, xyz, desc, ref_kf, new_valid, normal, min_dist, max_dist):
    """Append a batch of B candidate points at the watermark. Only rows with
    new_valid are created; rows beyond capacity are dropped. Returns
    (new_map, slots (B,) int32, -1 where no point was created).

    Dropped and invalid rows are parked at the last slot and write back its
    old value. Where a created row also lands there, a later parked row
    overwrites it, as the JAX package's in-order scatter does; n_pt still
    counts it."""
    P = m.capacity_pt
    order = torch.cumsum(new_valid.to(torch.int32), 0) - 1  # rank among valid
    idx = m.n_pt + order
    ok = new_valid & (idx < P)
    slot = torch.where(ok, idx, torch.full_like(idx, P - 1)).long()
    if isinstance(ref_kf, torch.Tensor):
        ref = ref_kf.to(torch.int32).expand(slot.shape)
    else:
        ref = torch.full(slot.shape, ref_kf, dtype=torch.int32, device=xyz.device)

    def put(a, v):
        """a.at[slot].set(where(ok, v, a[slot])); v a tensor or a scalar."""
        okb = ok[:, None] if a.dim() == 2 else ok
        return scatter_last(a, slot, torch.where(okb, v, a[slot]))

    n_new = ok.sum(dtype=torch.int32)
    m = m._replace(
        pt_xyz=put(m.pt_xyz, xyz),
        pt_desc=put(m.pt_desc, desc),
        pt_normal=put(m.pt_normal, normal),
        pt_min_dist=put(m.pt_min_dist, min_dist),
        pt_max_dist=put(m.pt_max_dist, max_dist),
        pt_ref_kf=put(m.pt_ref_kf, ref),
        pt_first_kf=put(m.pt_first_kf, ref),
        pt_valid=put(m.pt_valid, True),
        pt_found=put(m.pt_found, 1.0),
        pt_visible=put(m.pt_visible, 1.0),
        n_pt=torch.clamp(m.n_pt + n_new, max=P),
    )
    return m, torch.where(ok, slot.to(torch.int32), -1)


def compact_point_slots(m: MapState):
    """Re-pack valid points to the front of the point arrays and remap every
    observation (point-slot recycling at the watermark). The stable sort
    keeps creation order. Returns (compacted_map, old_to_new (P,) int32,
    -1 for culled slots); the caller remaps any slot references it holds
    outside the map."""
    P = m.capacity_pt
    dev = m.pt_valid.device
    perm = torch.argsort((~m.pt_valid).to(torch.int8), stable=True)
    old_to_new = torch.full((P,), -1, dtype=torch.int32, device=dev).scatter(
        0, perm, torch.arange(P, dtype=torch.int32, device=dev))
    old_to_new = torch.where(m.pt_valid, old_to_new, -1)
    obs = m.kf_obs_pt
    obs_new = torch.where(obs >= 0, old_to_new[obs.clamp(min=0).long()], obs)
    return m._replace(
        pt_xyz=m.pt_xyz[perm],
        pt_valid=m.pt_valid[perm],
        pt_desc=m.pt_desc[perm],
        pt_normal=m.pt_normal[perm],
        pt_min_dist=m.pt_min_dist[perm],
        pt_max_dist=m.pt_max_dist[perm],
        pt_ref_kf=m.pt_ref_kf[perm],
        pt_first_kf=m.pt_first_kf[perm],
        pt_found=m.pt_found[perm],
        pt_visible=m.pt_visible[perm],
        kf_obs_pt=obs_new,
        n_pt=m.pt_valid.sum(dtype=torch.int32),
    ), old_to_new


def _live_observations(m: MapState):
    """(has (K, N) bool, pt (K, N) int64): observations of valid keyframes
    and keypoints of valid points, parked at P where absent."""
    P = m.capacity_pt
    has = (m.kf_obs_pt >= 0) & m.kf_kp_valid & m.kf_valid[:, None]
    pt = torch.where(has, m.kf_obs_pt, P).long()
    pt_valid = torch.cat([m.pt_valid, m.pt_valid.new_zeros(1)])
    has = has & pt_valid[pt]
    return has, torch.where(has, pt, P)


def observation_incidence(m: MapState) -> torch.Tensor:
    """(K, P) float32 incidence matrix from the observation table. Culled
    points do not count."""
    K = m.kf_obs_pt.shape[0]
    P = m.capacity_pt
    has, pt = _live_observations(m)
    inc = torch.zeros((K, P + 1), dtype=torch.float32, device=pt.device)
    inc = inc.scatter_add(1, pt, has.to(torch.float32))
    return torch.clamp(inc[:, :P], max=1.0)


def covisibility_weights(m: MapState, block: int = 16384) -> torch.Tensor:
    """(K, K) covisibility weights: shared-point counts between keyframes
    (KeyFrame::UpdateConnections semantics, threshold applied by callers).
    Above `block` points the (K, P) incidence is never formed: blocks of
    points are scattered and multiplied one at a time, so memory stays
    O(K * block)."""
    K = m.kf_obs_pt.shape[0]
    P = m.capacity_pt
    if P <= block:
        inc = observation_incidence(m)
        w = inc @ inc.T
        return w - torch.diag(torch.diag(w))
    has, pt = _live_observations(m)
    w = torch.zeros((K, K), dtype=torch.float32, device=pt.device)
    for off in range(0, P, block):
        local = pt - off
        in_blk = has & (local >= 0) & (local < block)
        li = torch.where(in_blk, local, block)
        inc = torch.zeros((K, block + 1), dtype=torch.float32, device=pt.device)
        inc = torch.clamp(inc.scatter_add(1, li, in_blk.to(torch.float32))[:, :block], max=1.0)
        w = w + inc @ inc.T
    return w - torch.diag(torch.diag(w))


def shared_point_counts(m: MapState, anchor) -> torch.Tensor:
    """(K,) float32 counts of valid points each keyframe shares with
    keyframe `anchor` (an int or a 0-d tensor): one covisibility row
    without the (K, P) incidence. Each point counts once per keyframe,
    in step with observation_incidence's clamp."""
    K = m.kf_obs_pt.shape[0]
    P = m.capacity_pt
    has, pt = _live_observations(m)
    if isinstance(anchor, torch.Tensor):  # a 1-d index: no host read of a device scalar
        row = pt.index_select(0, anchor.reshape(1).long())[0]
    else:
        row = pt[anchor]
    mark = torch.zeros(P + 1, dtype=torch.bool, device=pt.device).index_fill(0, row, True)
    mark = torch.cat([mark[:P], mark.new_zeros(1)])  # no host-scalar item write: no sync
    v = torch.sort(torch.where(has & mark[pt], pt, P), dim=1).values
    first = torch.cat([torch.ones((K, 1), dtype=torch.bool, device=pt.device),
                       v[:, 1:] != v[:, :-1]], dim=1)
    return (first & (v < P)).sum(dim=1).to(torch.float32)


def _nanmedian_last(d: torch.Tensor) -> torch.Tensor:
    """jnp.nanmedian over the last dim: the mean of the two middle values
    for an even count of non-NaN entries (torch.nanmedian takes the lower
    one), NaN where there is none."""
    s = torch.sort(d, dim=-1).values  # NaN sorts last
    cnt = (~torch.isnan(d)).sum(dim=-1, keepdim=True).to(torch.float32)
    q = 0.5 * (cnt - 1.0)
    lo, hi = torch.floor(q), torch.ceil(q)
    w_hi = q - lo
    w_lo = 1.0 - w_hi
    n = d.shape[-1]
    lo_i = torch.clamp(torch.minimum(lo, cnt - 1.0), 0, n - 1).long()
    hi_i = torch.clamp(torch.minimum(hi, cnt - 1.0), 0, n - 1).long()
    out = torch.gather(s, -1, lo_i) * w_lo + torch.gather(s, -1, hi_i) * w_hi
    return out[..., 0]


def compute_point_descriptors(m: MapState, pt_mask: torch.Tensor, max_obs: int = 16) -> MapState:
    """Refresh the representative descriptor of the masked points: of up to
    max_obs observing keypoints' descriptors, the one with the least median
    Hamming distance to the others (MapPoint::ComputeDistinctiveDescriptors).
    """
    K, N = m.kf_obs_pt.shape
    P = m.capacity_pt
    dev = m.kf_obs_pt.device
    flat_pt = torch.where(
        (m.kf_obs_pt >= 0) & m.kf_kp_valid & m.kf_valid[:, None], m.kf_obs_pt, P
    ).reshape(-1).long()
    flat_desc = m.kf_kp_desc.reshape(-1, 8)
    # Each point's first max_obs observing edges: sort edges by point id
    # (stable, as jnp.argsort) and rank them within their run.
    order = torch.argsort(flat_pt, stable=True)
    sorted_pt = flat_pt[order]
    pos = torch.arange(sorted_pt.shape[0], device=dev)
    is_start = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                          sorted_pt[1:] != sorted_pt[:-1]])
    start = torch.cummax(torch.where(is_start, pos, -1), dim=0).values
    rank = pos - start
    tgt_ok = (sorted_pt < P) & (rank < max_obs)
    rows = torch.where(tgt_ok, sorted_pt, P)
    cols = torch.where(tgt_ok, rank, 0)
    table = torch.full((P + 1, max_obs), -1, dtype=torch.int64, device=dev)
    table = table.index_put((rows, cols), torch.where(tgt_ok, order, -1))[:P]
    has_obs = table >= 0
    descs = flat_desc[table.clamp(min=0)]  # (P, max_obs, 8)

    # Pairwise Hamming per point, one word at a time (one (P, M, M) plane).
    w = _words(descs)
    d = None
    for k in range(8):
        pc = _popcount32(w[:, :, None, k] ^ w[:, None, :, k])
        d = pc if d is None else d + pc
    d = d.to(torch.float32)
    pair_ok = has_obs[:, :, None] & has_obs[:, None, :]
    d = torch.where(pair_ok, d, float("nan"))
    med = _nanmedian_last(d)  # (P, max_obs) median distance to the others
    med = torch.where(has_obs & ~torch.isnan(med), med, float("inf"))
    best = torch.argmin(med, dim=1)
    new_desc = torch.gather(descs, 1, best[:, None, None].expand(P, 1, 8))[:, 0]
    use = pt_mask & m.pt_valid & has_obs.any(dim=1)
    return m._replace(pt_desc=torch.where(use[:, None], new_desc, m.pt_desc))


def update_point_normals(m: MapState, scale_factors: torch.Tensor) -> MapState:
    """Refresh viewing normals and scale-invariance distance ranges
    (MapPoint::UpdateNormalAndDepth): the normal is the mean of the unit
    vectors from the observing camera centres to the point; [min, max]
    distance comes from the reference keyframe's observation octave with
    the 0.8 / 1.2 margins."""
    K, N = m.kf_obs_pt.shape
    P = m.capacity_pt
    dev = m.kf_obs_pt.device
    has = (m.kf_obs_pt >= 0) & m.kf_kp_valid & m.kf_valid[:, None]
    pt = torch.where(has, m.kf_obs_pt, P).long()
    C = -torch.einsum("kij,ki->kj", m.kf_R, m.kf_t)  # camera centres (K, 3)
    # Edge-wise sums: (K*N, 3) rather than (K, P, 3).
    flat_pt = pt.reshape(-1)
    ok = has.reshape(-1)
    Xe = m.pt_xyz[torch.clamp(flat_pt, max=P - 1)]
    ve = Xe - C.repeat_interleave(N, dim=0)
    ve = ve / torch.clamp(torch.linalg.norm(ve, dim=-1, keepdim=True), min=1e-9)
    # The unit vectors' sums in a fixed order: index_add_ on the card would
    # add them in another order each run.
    nsum = scatter_sum(P, flat_pt, torch.where(ok[:, None], ve, 0.0))
    ncnt = torch.zeros(P + 1, dtype=torch.float32, device=dev).index_add(
        0, flat_pt, ok.to(torch.float32))[:P]
    normal = nsum / torch.clamp(ncnt[:, None], min=1.0)

    # Distance range from the reference keyframe's observation octave.
    ref = torch.clamp(m.pt_ref_kf, 0, K - 1).long()
    dist = torch.linalg.norm(m.pt_xyz - C[ref], dim=-1)
    # The first slot of the reference keyframe that holds the point, 0 where
    # none does (JAX's argmax over kf_obs_pt[ref] == p), as a min over the
    # (K, N) table: no (P, N) plane.
    obs = m.kf_obs_pt.reshape(-1)
    kf_of = torch.arange(K, device=dev).repeat_interleave(N)
    hit = (obs >= 0) & (kf_of == ref[obs.clamp(min=0).long()])
    first = torch.full((P + 1,), N, dtype=torch.int64, device=dev).scatter_reduce(
        0, torch.where(hit, obs, P).long(), torch.arange(N, device=dev).repeat(K),
        reduce="amin", include_self=True)[:P]
    has_ref = first < N
    slot = torch.where(has_ref, first, 0)
    octave = m.kf_kp_level[ref, slot].long()
    n_levels = scale_factors.shape[0]
    max_dist = dist * scale_factors[torch.clamp(octave, 0, n_levels - 1)]
    min_dist = max_dist / scale_factors[n_levels - 1]
    upd = m.pt_valid & (ncnt > 0)
    return m._replace(
        pt_normal=torch.where(upd[:, None], normal, m.pt_normal),
        pt_min_dist=torch.where(upd & has_ref, 0.8 * min_dist, m.pt_min_dist),
        pt_max_dist=torch.where(upd & has_ref, 1.2 * max_dist, m.pt_max_dist),
    )
