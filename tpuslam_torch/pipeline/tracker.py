"""Host-side tracking orchestrator: the state machine of the reference's
Tracking thread over the port's step functions, for monocular, stereo and
RGB-D input. Port of tpuslam/pipeline/tracker.py.

States: NO_IMAGES_YET, NOT_INITIALIZED, OK, LOST. Per frame: ORB
extraction (stereo: both images in one batch, then stereo matching; RGB-D:
the depth image sampled at each keypoint) -> (two-view initialization, or
one keyframe from the depths | the fused tracking step) -> NeedNewKeyFrame
-> LocalMapping (mapping_front), two chunks of local BA and loop closing
(detection, and on a loop the correction and global BA), synchronously on
each keyframe -> relocalization when LOST, from the BoW database's
keyframe candidates first. A depth sensor's keyframes
add map points from their close depths, and in localization mode its
frames also track visual-odometry points made from the last frame's depths.

The device is the tracker's (`device`, "cuda" unless the caller asks for
the CPU). A steady-state frame makes one packed device->host fetch beyond
the fused step's own verdict read; keyframe slots are assigned on the host,
so insertion never reads the device watermark. Random hypotheses (two-view
and PnP RANSAC) come from a torch.Generator the tracker owns, seeded from
its config, through `_draw_picks`.

Not ported yet, and refused with NotImplementedError: background or
multi-process mapping and the distributed bundle adjuster (ROADMAP A12).
"""

from __future__ import annotations

import contextlib
import dataclasses
import enum
from typing import Optional

import numpy as np
import torch

from tpuslam_torch.geometry.camera import PinholeCamera, undistort_points, unproject
from tpuslam_torch.geometry.se3 import se3_apply, se3_compose, se3_inverse
from tpuslam_torch.mapstate.core import (
    FrameFeatures,
    MapState,
    _nanmedian_last,
    compact_point_slots,
    covisibility_weights,
    insert_keyframe,
    insert_points,
    make_empty_map,
    shared_point_counts,
    update_point_normals,
)
from tpuslam_torch.matching.search import match_nn_ratio, search_for_initialization
from tpuslam_torch.ops.orb import ORBConfig, extract_orb
from tpuslam_torch.optim.ba import BAProblem, bundle_adjustment
from tpuslam_torch.pipeline import steps
from tpuslam_torch.pipeline._index import scatter_last
from tpuslam_torch.pipeline.loop_closing import LoopCloser
from tpuslam_torch.place.vocabulary import sparse_bow_vector
from tpuslam_torch.sfm.initializer import draw_picks, initialize_two_view
from tpuslam_torch.sfm.pnp import pnp_ransac
from tpuslam_torch.utils.metrics import Metrics


class TrackingState(enum.Enum):
    NO_IMAGES_YET = 0
    NOT_INITIALIZED = 1
    OK = 2
    LOST = 3


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    """The JAX package's TrackerConfig, every field and default, plus the
    seed of the tracker's hypothesis generator."""

    cam: PinholeCamera
    orb: ORBConfig = ORBConfig()
    # Map capacity (a KITTI-00-scale session without forced eviction).
    max_keyframes: int = 1536
    max_points: int = 200_000
    # NeedNewKeyFrame cadence and reference ratios (mono / stereo+RGB-D).
    kf_max_frames: int = 30
    kf_min_frames: int = 1
    kf_ref_ratio: float = 0.9
    kf_ref_ratio_depth: float = 0.75
    min_inliers_ok: int = 30       # TrackLocalMap acceptance
    min_inliers_motion: int = 10   # motion-model acceptance
    local_ba_window: int = 8
    # LocalMapping breadth: triangulation / fusion neighbours (0 = 20 mono,
    # 10 stereo/RGB-D) and the second-hop fusion neighbours of each.
    tri_neighbors: int = 0
    fuse_neighbors: int = 0
    fuse_second_hop: int = 5
    # Local BA caps: compacted edge block (0 = 32 x n_features) and the
    # dense reduced-camera window.
    local_ba_max_edges: int = 0
    local_ba_active_max: int = 32
    local_ba_cg_iters: int = 40    # CG budget of the distributed solvers
    init_min_matches: int = 100    # MonocularInitialization
    th_depth_factor: float = 40.0
    depth_map_factor: float = 1.0
    enable_loop_closing: bool = True
    async_mapping: bool = False
    mapping_process: bool = False
    mapping_process_platform: str = "cpu"
    # TrackLocalMap local-subset cap (0 = 16384 when max_points > 16384).
    local_map_max_pts: int = 0
    dist_ba_devices: int = 0
    # Seed of the torch.Generator that draws the RANSAC hypotheses.
    seed: int = 0


def _unported(cfg: TrackerConfig) -> Optional[str]:
    if cfg.async_mapping or cfg.mapping_process:
        return "async_mapping / mapping_process: background and multi-process mapping (ROADMAP A12)"
    if cfg.dist_ba_devices >= 2:
        return "dist_ba_devices >= 2: the point-sharded bundle adjuster (ROADMAP A12)"
    return None


def pad_feats(feats: FrameFeatures, cap: int) -> FrameFeatures:
    """Pad a frame's keypoint arrays to the keyframe capacity `cap`:
    invalid, mono, no depth."""
    pad = cap - feats.xy.shape[0]
    if pad == 0:
        return feats

    def p(a, fill=0):
        return torch.cat([a, torch.full((pad, *a.shape[1:]), fill, dtype=a.dtype, device=a.device)])

    return FrameFeatures(xy=p(feats.xy), level=p(feats.level), angle=p(feats.angle),
                         desc=p(feats.desc), valid=p(feats.valid, False),
                         u_right=p(feats.u_right, -1.0), depth=p(feats.depth))


def _set(a: torch.Tensor, i: int, v) -> torch.Tensor:
    """a.at[i].set(v) with a host index."""
    a = a.clone()
    a[i] = v
    return a


class Tracker:
    """Single-session SLAM tracker: monocular, stereo or RGB-D."""

    def __init__(self, config: TrackerConfig, device="cuda"):
        why = _unported(config)
        if why is not None:
            raise NotImplementedError(f"not ported yet: {why}")
        self.cfg = config
        self.device = torch.device(device)
        self.state = TrackingState.NO_IMAGES_YET
        # Keyframes hold 2 x n_features keypoints: monocular initialization
        # extracts twice the features and the two bootstrap keyframes keep them.
        self.kp_capacity = 2 * config.orb.n_features
        self.map: MapState = self._empty_map()
        nl, sf = config.orb.n_levels, config.orb.scale_factor
        self.scale_factors = torch.tensor([sf**l for l in range(nl)], dtype=torch.float32,
                                          device=self.device)
        self.inv_sigma2 = torch.tensor([1.0 / (sf**l) ** 2 for l in range(nl)],
                                       dtype=torch.float32, device=self.device)
        self._init_orb = dataclasses.replace(config.orb, n_features=self.kp_capacity)
        self.generator = torch.Generator().manual_seed(config.seed)
        # Block at each mapping stage's end so the stage timers hold device time.
        self.stage_sync = False
        self.metrics = Metrics()
        self.stats = {"dispatches": 0, "syncs": 0, "fused_frames": 0, "slow_frames": 0}
        # Trajectory: (frame_id, ref_kf, R_rel, t_rel, lost), resolved against
        # the optimized keyframe poses at export.
        self.trajectory = []
        self.n_frames = 0
        self.n_recycled_kf_slots = 0
        self.localization_mode = False
        # The last relocalization's frame (mnLastRelocFrameId); a reset keeps it.
        self._last_reloc_frame_id = -(10**9)
        self.reloc_path: Optional[str] = None  # the last relocalization's: "bow" or "brute_force"
        # Loop closing (scale fixed once a depth sensor initialized the map).
        self.loop_closer: Optional[LoopCloser] = None
        if config.enable_loop_closing:
            self.loop_closer = self._new_loop_closer(None)
        self._reset_tracking()

    def _new_loop_closer(self, voc) -> LoopCloser:
        lc = LoopCloser(self.cfg.max_keyframes, fix_scale=False, voc=voc)
        lc.metrics = self.metrics  # its stages ("loop.*") time with the tracker's
        return lc

    def _empty_map(self) -> MapState:
        return make_empty_map(self.cfg.max_keyframes, self.kp_capacity, self.cfg.max_points,
                              self.device)

    def _reset_tracking(self):
        self._init_feats: Optional[FrameFeatures] = None
        self._init_frame_id = -1
        self._last_feats: Optional[FrameFeatures] = None
        self._last_obs: Optional[torch.Tensor] = None
        self._last_R = torch.eye(3, device=self.device)
        self._last_t = torch.zeros(3, device=self.device)
        self._velocity = None  # (R, t) of T_cur T_last^-1
        self._frames_since_kf = 0
        self._last_kf_idx = -1
        self._n_kf_host = 0  # host mirror of the keyframe watermark
        self._last_pose_np = None  # the current pose from the packed fetch
        self._pending_pt_remap = None  # old -> new point slots after compaction
        # Set by a stereo / RGB-D initialization (a reset clears it).
        self._depth_mode = False
        # Localization-mode visual odometry: _vo_mode is the reference's mbVO
        # (the last frame tracked mostly VO points); _vo_xyz (N, 3) and
        # _vo_valid (N,) are the last frame's VO points in the world.
        self._vo_mode = False
        self._vo_xyz: Optional[torch.Tensor] = None
        self._vo_valid: Optional[torch.Tensor] = None

    # ------------------------------------------------------------------ util

    def _draw_picks(self, n_hyp: int, size: int, valid: torch.Tensor) -> torch.Tensor:
        """The index sets of a RANSAC batch (initialization: 200 x 8, PnP:
        128 x 4), from the tracker's generator."""
        return draw_picks(n_hyp, size, valid, self.generator)

    @staticmethod
    def _fetch(*scalars) -> np.ndarray:
        """Several device scalars in one device->host read."""
        return torch.stack([torch.as_tensor(s).to(torch.float32) for s in scalars]).cpu().numpy()

    @contextlib.contextmanager
    def _stage(self, name: str):
        with self.metrics.stage(name):
            yield
            if self.stage_sync and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

    def _mono_features(self, f) -> FrameFeatures:
        """FrameFeatures of one image's ORBFeatures: undistorted xy, no depth."""
        xy = f.xy
        c = self.cfg.cam
        if abs(c.k1) > 1e-12 or abs(c.k2) > 1e-12:
            xy = undistort_points(c, xy)
        n = xy.shape[0]
        return FrameFeatures(xy=xy, level=f.level, angle=f.angle, desc=f.desc, valid=f.valid,
                             u_right=torch.full((n,), -1.0, device=xy.device),
                             depth=torch.zeros((n,), device=xy.device))

    def _frame_features(self, img: torch.Tensor, init: bool = False) -> FrameFeatures:
        return self._mono_features(extract_orb(img, self._init_orb if init else self.cfg.orb))

    def _pad_feats(self, feats: FrameFeatures) -> FrameFeatures:
        return pad_feats(feats, self.kp_capacity)

    @staticmethod
    def _pose_np(R: torch.Tensor, t: torch.Tensor):
        """(R, t) on the host in one device->host read."""
        p = torch.cat([R.reshape(-1), t.reshape(-1)]).cpu().numpy()
        return p[:9].reshape(3, 3), p[9:12]

    def _record_pose(self, frame_id, R, t, lost=False):
        ref = self._last_kf_idx
        if ref >= 0:
            R, t = se3_compose(R, t, *se3_inverse(self.map.kf_R[ref], self.map.kf_t[ref]))
        self.trajectory.append((frame_id, ref, *self._pose_np(R, t), lost))

    # ------------------------------------------------------- initialization

    def _try_initialize(self, feats: FrameFeatures, frame_id: int) -> bool:
        cfg = self.cfg
        if self._init_feats is None or int(self._init_feats.valid.sum()) <= cfg.init_min_matches:
            self._init_feats = feats
            self._init_frame_id = frame_id
            return False
        ref = self._init_feats
        idx, _, ok = search_for_initialization(
            ref.xy, ref.desc, ref.level, ref.angle, ref.valid,
            feats.xy, feats.desc, feats.level, feats.angle, feats.valid, window=100.0)
        if int(ok.sum()) < cfg.init_min_matches:
            self._init_feats = feats  # a new reference frame
            self._init_frame_id = frame_id
            return False
        with self._stage("init.two_view"):
            res = initialize_two_view(cfg.cam.K, ref.xy, feats.xy[idx], ok,
                                      picks=self._draw_picks(200, 8, ok))
        if not bool(res.success):
            return False
        return self._create_initial_map(ref, feats, idx, res, frame_id)

    def _create_initial_map(self, ref, cur, idx, res, frame_id) -> bool:
        """CreateInitialMapMonocular: two keyframes, the triangulated points,
        global BA, median depth scaled to 1."""
        cfg = self.cfg
        dev = self.device
        N = ref.xy.shape[0]
        good = res.inliers
        med = _nanmedian_last(torch.where(good, res.points[:, 2], float("nan")))
        med = torch.where(torch.isnan(med) | (med <= 0), 1.0, med)
        X = res.points / med
        t2 = res.t / med

        r2v = X - (-(res.R.T @ t2))
        lo, hi = self._point_ranges(torch.linalg.norm(r2v, dim=-1), cur.level[idx])
        m, slots = insert_points(
            self.map, X, cur.desc[idx], 1, good,  # keyframe 1 is their reference
            r2v / torch.clamp(torch.linalg.norm(r2v, dim=-1, keepdim=True), min=1e-9), lo, hi)
        obs0 = torch.where(good, slots, -1).to(torch.int32)
        # Keyframe 1's table runs over its own keypoints: scatter through idx.
        obs1 = torch.full((N,), -1, dtype=torch.int32, device=dev)
        obs1 = scatter_last(obs1, idx, torch.where(good, slots, obs1[idx]))
        m, _ = insert_keyframe(m, ref, torch.eye(3, device=dev), torch.zeros(3, device=dev),
                               self._init_frame_id, obs0)
        m, _ = insert_keyframe(m, cur, res.R, t2, frame_id, obs1)
        with self._stage("init.global_ba"):
            m = self._global_ba(m, iters=20)

        # Weak-geometry rejection: a wrong decomposition that global BA
        # collapses to a baseline below 2% of the median depth restarts.
        med_ba = _nanmedian_last(torch.where(m.pt_valid, m.pt_xyz[:, 2], float("nan")))
        med_ba, baseline = (float(v) for v in self._fetch(med_ba, torch.linalg.norm(m.kf_t[1])))
        if not np.isfinite(med_ba) or baseline < 0.02 * max(med_ba, 1e-6):
            self.map = self._empty_map()
            self._init_feats = None
            return False

        self.map = update_point_normals(m, self.scale_factors)
        self.state = TrackingState.OK
        self._last_feats = cur
        self._last_obs = obs1
        self._last_R, self._last_t = self.map.kf_R[1], self.map.kf_t[1]
        self._velocity = None
        self._last_kf_idx = 1
        self._frames_since_kf = 0
        self._n_kf_host = 2
        self._record_pose(frame_id, self._last_R, self._last_t)
        return True

    def _global_ba(self, m: MapState, iters: int = 20) -> MapState:
        """Global BA over every observation of the map, keyframe 0 fixed.
        The solver takes the live edges only (one read: their count), where
        the JAX package passes all K*N slots with the dead ones at zero
        weight: the same sums, in another order."""
        K, N = m.kf_obs_pt.shape
        kfi = torch.arange(K, dtype=torch.int32, device=self.device).repeat_interleave(N)
        pti = m.kf_obs_pt.reshape(-1)
        has = (pti >= 0) & m.kf_kp_valid.reshape(-1) & m.kf_valid[kfi.long()]
        live = torch.nonzero(has & m.pt_valid[pti.clamp(min=0).long()])[:, 0]
        uvr = torch.cat([m.kf_kp_xy.reshape(K * N, 2), m.kf_kp_uright.reshape(K * N, 1)], dim=-1)
        lvl = torch.clamp(m.kf_kp_level.reshape(-1), 0, self.inv_sigma2.shape[0] - 1).long()
        prob = BAProblem(
            R=m.kf_R, t=m.kf_t, X=m.pt_xyz, kf=kfi[live], pt=pti[live], uvr=uvr[live],
            inv_sigma2=self.inv_sigma2[lvl[live]],
            valid=torch.ones(live.shape, dtype=torch.bool, device=self.device),
            fixed_kf=~m.kf_valid | (torch.arange(K, device=self.device) == 0),
            fixed_pt=~m.pt_valid,
        )
        R, t, X, _ = self._run_ba(prob, iters=iters)
        return m._replace(kf_R=R, kf_t=t, pt_xyz=X)

    def _run_ba(self, prob: BAProblem, iters: int):
        """The single-device solver (the point-sharded one is refused at
        construction)."""
        return bundle_adjustment(self.cfg.cam, prob, iters=iters)

    def _local_ba(self, m: MapState, center_kf: int, iters: int = 8) -> MapState:
        cfg = self.cfg
        return steps.local_bundle_adjustment(
            cfg.cam, m, center_kf, self.inv_sigma2, window=cfg.local_ba_window,
            n_levels=cfg.orb.n_levels, iters=iters,
            max_edges=cfg.local_ba_max_edges or 32 * cfg.orb.n_features,
            active_max=cfg.local_ba_active_max)

    # ------------------------------------------------------------- tracking

    def _local_subset_cap(self) -> int:
        cap = self.cfg.local_map_max_pts or (16384 if self.map.capacity_pt > 16384 else 0)
        return cap if 0 < cap < self.map.capacity_pt else 0

    def _cand_cap(self) -> int:
        """TrackLocalMap candidate compaction: half the local subset."""
        cap = self._local_subset_cap() or self.map.capacity_pt
        return min(8192, cap) if cap > 4096 else 0

    def _track_local_map(self, m: MapState, R, t, feats, obs):
        """TrackLocalMap over the whole map, or over the covisibility-local
        subset on a large map."""
        cfg = self.cfg
        cap = self._local_subset_cap()
        kwargs = {}
        if cap:
            kwargs = dict(local_kf_mask=steps.local_keyframe_mask(
                m, obs, ref_kf=max(self._last_kf_idx, 0)), max_local_pts=cap)
        return steps.track_local_map(
            cfg.cam, m, R, t, feats, obs, self.inv_sigma2, scale_factor=cfg.orb.scale_factor,
            n_levels=cfg.orb.n_levels, cand_cap=self._cand_cap(), **kwargs)

    def _predict_pose(self):
        if self._velocity is not None:
            return se3_compose(*self._velocity, self._last_R, self._last_t)
        return self._last_R, self._last_t

    def _ref_kf_estimate(self, feats: FrameFeatures):
        """TrackReferenceKeyFrame from the last frame's pose. Returns (ok, R,
        t, obs): >= 15 matches to try, >= 10 map inliers to accept."""
        ref = self._last_kf_idx
        if ref < 0:
            return False, None, None, None
        R, t, obs, n_matches, n_inl = steps.track_reference_keyframe(
            self.cfg.cam, self.map, ref, feats, self._last_R, self._last_t, self.inv_sigma2)
        nm, ni = self._fetch(n_matches, n_inl)
        if nm < 15 or ni < 10:
            return False, None, None, None
        return True, R, t, obs

    def _accept_thr(self, frame_id: int) -> int:
        """TrackLocalMap's inlier bar: 50 within kf_max_frames of a
        relocalization."""
        cfg = self.cfg
        if frame_id < self._last_reloc_frame_id + cfg.kf_max_frames:
            return max(cfg.min_inliers_ok, 50)
        return cfg.min_inliers_ok

    def _track_frame(self, feats: Optional[FrameFeatures], frame_id: int,
                     img: Optional[torch.Tensor] = None) -> bool:
        """The steady-state frame: the fused step (from the image when `img`
        is given) and one packed fetch. A motion-model estimate that
        TrackLocalMap rejects is retried through the reference keyframe."""
        if self.localization_mode and self._depth_mode:
            return self._track_frame_localization(feats, frame_id)
        cfg = self.cfg
        dev = self.device
        thr = self._accept_thr(frame_id)
        has_vel = self._velocity is not None and frame_id >= self._last_reloc_frame_id + 2
        vel_R, vel_t = self._velocity if has_vel else (torch.eye(3, device=dev),
                                                        torch.zeros(3, device=dev))
        ref = max(self._last_kf_idx, 0)
        common = dict(min_inliers_motion=cfg.min_inliers_motion,
                      max_local_pts=self._local_subset_cap(), cand_cap=self._cand_cap())
        with self.metrics.stage("track.dispatch"):
            if img is not None:
                feats, *out = steps.fused_track_frame_image(
                    cfg.cam, cfg.orb, self.map, img, self._last_feats, self._last_obs,
                    self._last_R, self._last_t, vel_R, vel_t, has_vel, ref, self.inv_sigma2,
                    float(thr), **common)
            else:
                out = steps.fused_track_frame(
                    cfg.cam, self.map, self._last_feats, self._last_obs, self._last_R,
                    self._last_t, vel_R, vel_t, has_vel, feats, ref, self.inv_sigma2,
                    self._th_depth, float(thr), scale_factor=cfg.orb.scale_factor,
                    n_levels=cfg.orb.n_levels, depth=self._depth_mode, **common)
        R, t, obs, vel_R2, vel_t2, pt_visible, pt_found, packed = out
        self.stats["dispatches"] += 1
        with self.metrics.stage("track.fetch"):
            p = packed.cpu().numpy()  # the per-frame device->host read
        self.stats["syncs"] += 1
        used_mm = p[steps.FUSED_USED_MM] > 0.5
        self.metrics.inc("frames.motion_model" if used_mm else "frames.reference_kf")

        if p[steps.FUSED_ACCEPT] > 0.5:
            self.stats["fused_frames"] += 1
            self.map = self.map._replace(pt_visible=pt_visible, pt_found=pt_found)
            self._velocity = (vel_R2, vel_t2)
            self._last_R, self._last_t = R, t
            self._last_feats = feats
            self._last_obs = obs
            self._frames_since_kf += 1
            n_tracked = int(p[steps.FUSED_N_TRACKED])
            gates = p[steps.FUSED_GATES:steps.FUSED_GATES + 4]
            if self._need_new_keyframe(n_tracked, frame_id, gates):
                self._create_keyframe(feats, obs, R, t, frame_id)
                self._last_pose_np = None
                # Recorded after the keyframe: local BA refined the pose.
                self._record_pose(frame_id, self._last_R, self._last_t)
            else:
                o = steps.FUSED_REL
                self.trajectory.append((frame_id, self._last_kf_idx,
                                        p[o:o + 9].reshape(3, 3).astype(np.float64),
                                        p[o + 9:o + 12].astype(np.float64), False))
                o = steps.FUSED_POSE
                self._last_pose_np = (p[o:o + 9].reshape(3, 3), p[o + 9:o + 12])
            return True

        if used_mm:
            # The motion model passed its gates on a few aliased matches but
            # TrackLocalMap rejected the pose: retry through the reference
            # keyframe before declaring LOST.
            self.stats["slow_frames"] += 1
            ok, R2, t2, obs2 = self._ref_kf_estimate(feats)
            if ok:
                R, t, obs, n_inl, visible, found = self._track_local_map(self.map, R2, t2, feats, obs2)
                g = steps.keyframe_gates(self.map, ref, feats, obs, self._th_depth,
                                         depth=self._depth_mode)
                packed2 = self._fetch(n_inl, *g)
                n_tracked = int(packed2[0])
                if n_tracked >= thr:
                    self.map = self.map._replace(
                        pt_visible=self.map.pt_visible + visible.to(torch.float32),
                        pt_found=self.map.pt_found + found.to(torch.float32))
                    self._velocity = se3_compose(R, t, *se3_inverse(self._last_R, self._last_t))
                    self._last_R, self._last_t = R, t
                    self._last_feats = feats
                    self._last_obs = obs
                    self._frames_since_kf += 1
                    self._last_pose_np = None
                    if self._need_new_keyframe(n_tracked, frame_id, packed2[1:]):
                        self._create_keyframe(feats, obs, R, t, frame_id)
                    self._record_pose(frame_id, self._last_R, self._last_t)
                    return True
        return False

    def _need_new_keyframe(self, n_tracked: int, frame_id: int, gates) -> bool:
        """NeedNewKeyFrame with synchronous mapping, so LocalMapping is
        always idle (the reference's c1b holds whenever kf_min_frames have
        passed, and nothing is ever interrupted): not right after a
        relocalization on an established map; then the cadence (c1a
        kf_max_frames, c1b kf_min_frames) or, for a depth sensor, weak
        tracking (c1c: under a quarter of the reference's points, or the
        close-point pressure need_close: < 100 close points tracked and > 70
        untracked), and the reference ratio (0.4 below two keyframes, else
        kf_ref_ratio, or kf_ref_ratio_depth for a depth sensor) or
        need_close, with more than 15 tracked points. `gates` is the
        keyframe_gates pack, already on the host."""
        cfg = self.cfg
        if self.localization_mode:
            return False
        n_kf = int(gates[0])
        if frame_id < self._last_reloc_frame_id + cfg.kf_max_frames and n_kf > cfg.kf_max_frames:
            return False
        ref_matches = int(gates[1])
        depth = self._depth_mode
        need_close = depth and gates[2] < 100 and gates[3] > 70
        if n_kf < 2:
            th_ref = 0.4
        else:
            th_ref = cfg.kf_ref_ratio_depth if depth else cfg.kf_ref_ratio
        c1a = self._frames_since_kf >= cfg.kf_max_frames
        c1b = self._frames_since_kf >= cfg.kf_min_frames
        c1c = depth and (n_tracked < 0.25 * ref_matches or need_close)
        c2 = (n_tracked < th_ref * ref_matches or need_close) and n_tracked > 15
        return bool((c1a or c1b or c1c) and c2)

    # ------------------------------------------------- keyframes and slots

    def _create_keyframe(self, feats, obs, R, t, frame_id):
        n = feats.xy.shape[0]
        if n < self.kp_capacity:
            feats = self._pad_feats(feats)
            obs = torch.cat([obs, obs.new_full((self.kp_capacity - n,), -1)])
        slot = None
        if self._n_kf_host >= self.map.capacity_kf:
            slot = self._recycle_kf_slot()
            if slot is None:
                return  # full, nothing recyclable
        ki = self._n_kf_host if slot is None else slot
        m, _ = insert_keyframe(self.map, feats, R, t, frame_id, obs, slot=slot)
        if slot is None:
            self._n_kf_host += 1
        if self._depth_mode:
            m = self._add_depth_points(m, ki, feats, R, t)
        self.metrics.inc("frames.keyframe")
        self.map = self._mapping_compute(m, ki)
        self._apply_pt_remap()
        self._last_kf_idx = ki
        self._frames_since_kf = 0
        # The tracker follows the BA-refined keyframe pose.
        self._last_R, self._last_t = self.map.kf_R[ki], self.map.kf_t[ki]
        self._velocity = None

    def _force_evict_kf(self) -> bool:
        """Mark the valid keyframe least covisible with the reference one
        (the oldest on a tie) culled, so its slot can be recycled; the origin
        pair, the reference and the recent window are protected."""
        m = self.map
        valid = m.kf_valid.cpu().numpy()
        fid = m.kf_frame_id.cpu().numpy().astype(np.int64)
        protect = {0, 1, self._last_kf_idx}
        fids = np.where(valid, fid, -1)
        protect |= {int(k) for k in np.argsort(-fids, kind="stable")[: self.cfg.local_ba_window]
                    if fids[k] >= 0}
        cands = [int(k) for k in np.nonzero(valid)[0] if int(k) not in protect]
        if not cands:
            return False
        anchor = self._last_kf_idx if self._last_kf_idx >= 0 else int(np.argmax(fids))
        shared = shared_point_counts(m, anchor).cpu().numpy()
        slot = min(cands, key=lambda k: (float(shared[k]), int(fid[k])))
        # Parent: the most covisible survivor, else the newest.
        s_row = shared_point_counts(m, slot).cpu().numpy()
        s_row[slot] = -1.0
        s_row[~valid] = -1.0
        p = int(np.argmax(s_row))
        if s_row[p] <= 0:
            fids2 = fids.copy()
            fids2[slot] = -1
            p = int(np.argmax(fids2))
        pR = m.kf_R[slot] @ m.kf_R[p].T
        self.map = m._replace(
            kf_valid=_set(m.kf_valid, slot, False),
            kf_obs_pt=_set(m.kf_obs_pt, slot, -1),
            kf_parent=_set(m.kf_parent, slot, p),
            kf_rel_R=_set(m.kf_rel_R, slot, pR),
            kf_rel_t=_set(m.kf_rel_t, slot, m.kf_t[slot] - pR @ m.kf_t[p]),
        )
        return True

    def _recycle_kf_slot(self):
        """The oldest culled keyframe slot for reuse at capacity (forcing an
        eviction when none is culled), with every reference to it rebased on
        its spanning-tree parent: trajectory entries, culled children and
        point reference keyframes. Returns the slot, or None."""
        m = self.map
        valid = m.kf_valid.cpu().numpy()
        parent = m.kf_parent.cpu().numpy()
        cand = np.nonzero(~valid & (parent >= 0))[0]
        if len(cand) == 0:
            if not self._force_evict_kf():
                return None
            m = self.map
            valid = m.kf_valid.cpu().numpy()
            parent = m.kf_parent.cpu().numpy()
            cand = np.nonzero(~valid & (parent >= 0))[0]
        fid = m.kf_frame_id.cpu().numpy()
        slot = int(cand[np.argmin(fid[cand])])
        self.n_recycled_kf_slots += 1
        p = int(parent[slot])
        pR = m.kf_rel_R[slot].cpu().numpy()
        pt_ = m.kf_rel_t[slot].cpu().numpy()
        self.trajectory = [
            (fi, p, Rr @ pR, Rr @ pt_ + tr, lost) if ref == slot else (fi, ref, Rr, tr, lost)
            for (fi, ref, Rr, tr, lost) in self.trajectory
        ]
        kf_parent, kf_rel_R, kf_rel_t = m.kf_parent, m.kf_rel_R, m.kf_rel_t
        pR_t, pt_t = m.kf_rel_R[slot], m.kf_rel_t[slot]
        for k in np.nonzero((parent == slot) & ~valid)[0]:
            k = int(k)
            kf_rel_t = _set(kf_rel_t, k, m.kf_rel_R[k] @ pt_t + m.kf_rel_t[k])
            kf_rel_R = _set(kf_rel_R, k, m.kf_rel_R[k] @ pR_t)
            kf_parent = _set(kf_parent, k, p)
        self.map = m._replace(
            kf_parent=kf_parent, kf_rel_R=kf_rel_R, kf_rel_t=kf_rel_t,
            pt_ref_kf=torch.where(m.pt_ref_kf == slot, p, m.pt_ref_kf),
            pt_first_kf=torch.where(m.pt_first_kf == slot, p, m.pt_first_kf),
        )
        return slot

    def _apply_pt_remap(self):
        """Rewrite the tracker's own point references after a compaction
        (old slots may already hold other points)."""
        r = self._pending_pt_remap
        if r is None:
            return
        self._pending_pt_remap = None
        if self._last_obs is not None:
            obs = self._last_obs
            self._last_obs = torch.where(obs >= 0, r[obs.clamp(0, r.shape[0] - 1).long()], obs)

    def _mapping_compute(self, m: MapState, ki: int) -> MapState:
        """The LocalMapping work for new keyframe ki, snapshot -> snapshot:
        point-slot compaction near capacity, mapping_front, two chunks of
        local BA, the normals, then loop closing when it is on."""
        cfg = self.cfg
        if int(m.n_pt) >= int(0.95 * m.capacity_pt):
            m, self._pending_pt_remap = compact_point_slots(m)
        # Neighbours and the culling's observation bar: 10 and 2 for a depth
        # sensor, 20 and 3 for a monocular map.
        nn_auto = 10 if self._depth_mode else 20
        with self._stage("map.front"):
            m = steps.mapping_front(
                cfg.cam, m, ki, self.inv_sigma2, 2.0 if self._depth_mode else 3.0,
                scale_factor=cfg.orb.scale_factor, n_levels=cfg.orb.n_levels,
                nn_tri=cfg.tri_neighbors or nn_auto, nn_fuse=cfg.fuse_neighbors or nn_auto,
                fuse_hop=cfg.fuse_second_hop, window=cfg.local_ba_window)
        with self._stage("map.local_ba1"):
            m = self._local_ba(m, ki, iters=4)
        with self._stage("map.local_ba2"):
            m = self._local_ba(m, ki, iters=4)
        with self._stage("map.normals"):
            m = update_point_normals(m, self.scale_factors)
        if self.loop_closer is not None:
            with self._stage("map.loop"):
                m = self._close_loops(m, ki)
        return m

    def _close_loops(self, m: MapState, ki: int) -> MapState:
        """The loop-closing hand-off of keyframe ki (LocalMapping -> LoopClosing).
        On a closure the normals are refreshed, and the fusion's point
        forwarding is composed with any compaction remap of this epoch, so the
        tracker's live references follow the surviving loop points."""
        lc = self.loop_closer
        lc.fix_scale = self._depth_mode
        lc.stage_sync = self.stage_sync
        m2, closed = lc.on_keyframe(m, self.cfg.cam, ki,
                                    ba_fn=lambda mm: self._schedule_gba(mm, iters=10))
        if not closed:
            return m
        m = update_point_normals(m2, self.scale_factors)
        rl = lc.last_point_remap
        if rl is not None:
            r1 = self._pending_pt_remap
            self._pending_pt_remap = rl if r1 is None else torch.where(
                r1 >= 0, rl[r1.clamp(min=0).long()], -1).to(torch.int32)
        return m

    def _schedule_gba(self, m: MapState, iters: int = 10) -> MapState:
        """Global BA for a freshly corrected loop, synchronously (mapping
        runs in the tracker's thread)."""
        return self._global_ba(m, iters=iters)

    # --------------------------------------------------------- relocalization

    def _match_frame_to_kf_points(self, feats: FrameFeatures, kf: int):
        """Match the frame's keypoints against keyframe kf's map points (the
        SearchByBoW step of Relocalization). Returns (pt_idx (N,), ok (N,))."""
        m = self.map
        obs_k = m.kf_obs_pt[kf]
        has_k = (obs_k >= 0) & m.kf_kp_valid[kf] & m.pt_valid[obs_k.clamp(min=0).long()]
        idx, _, ok = match_nn_ratio(feats.desc, m.kf_kp_desc[kf],
                                    feats.valid[:, None] & has_k[None, :], max_dist=50, nn_ratio=0.75)
        return torch.where(ok, obs_k[idx], -1), ok

    def _reloc_candidate_kfs(self, feats: FrameFeatures) -> Optional[list]:
        """BoW relocalization candidates (KeyFrameDatabase::
        DetectRelocalizationCandidates): the frame's BoW vector against the
        loop closer's database, with no min-score gate and no covisible
        exclusion. None without a vocabulary or a database."""
        lc = self.loop_closer
        if lc is None or lc.voc is None or lc.db is None:
            return None
        v = sparse_bow_vector(lc.voc, feats.desc, feats.valid)
        K = self.map.capacity_kf
        idx, ok = lc.db.query(v, torch.zeros(K, dtype=torch.bool, device=self.device),
                              covisibility_weights(self.map), min_score=0.0, max_candidates=3)
        got = torch.stack([idx, ok.to(idx.dtype)]).cpu().numpy()  # one read
        return [int(i) for i, o in zip(*got) if o] or None

    def _relocalize(self, feats: FrameFeatures, frame_id: int) -> bool:
        """Tracking::Relocalization: BoW keyframe candidates -> descriptor
        matching against each candidate's points -> EPnP RANSAC -> pose
        optimization -> up to two rounds of projective widening to reach 50
        inliers -> the local-map polish. Brute-force matching over every map
        point when no candidate yields 15 matches (or there is no database),
        accepted at the configured minimum."""
        m = self.map
        cfg = self.cfg
        n = feats.xy.shape[0]
        attempts = []  # (pt_idx (N,), ok (N,), source keyframe or -1)
        cand_kfs = self._reloc_candidate_kfs(feats)
        self.reloc_path = "bow" if cand_kfs else "brute_force"
        for kf in cand_kfs or ():
            pt_idx, ok = self._match_frame_to_kf_points(feats, kf)
            if int(ok.sum()) >= 15:
                attempts.append((pt_idx, ok, kf))
        if not attempts:
            self.reloc_path = "brute_force"
            pair = m.pt_valid[:, None] & feats.valid[None, :]
            idx, _, ok = match_nn_ratio(m.pt_desc, feats.desc, pair, max_dist=50, nn_ratio=0.75)
            if int(ok.sum()) < 15:
                return False
            pt_idx = torch.full((n,), -1, dtype=torch.int32, device=self.device)
            pt_idx = scatter_last(pt_idx, idx, torch.where(
                ok, torch.arange(m.capacity_pt, dtype=torch.int32, device=self.device), pt_idx[idx]))
            attempts.append((pt_idx, pt_idx >= 0, -1))

        best = None  # (n_good, R, t, obs)
        for pt_idx, ok, kf in attempts:
            valid = ok & (pt_idx >= 0)
            r = pnp_ransac(cfg.cam.K, m.pt_xyz[pt_idx.clamp(min=0).long()], feats.xy,
                           torch.ones(n, device=self.device), valid,
                           picks=self._draw_picks(128, 4, valid), min_inliers=15)
            if not bool(r.success):
                continue
            obs = torch.where(valid & r.inliers, pt_idx, -1)
            R, t, obs, n_inl = steps.optimize_frame_pose(cfg.cam, m, feats, obs, r.R, r.t,
                                                         self.inv_sigma2)
            n_good = int(n_inl)
            if n_good < 10:
                continue
            if n_good < 50 and kf >= 0:
                R, t, obs, n_good = self._reloc_widen(feats, kf, R, t, obs, n_good)
            # 50 inliers on a BoW candidate (bMatch); the brute-force match
            # accepts the configured minimum and leaves the rest to the local
            # map's gate.
            accept = 50 if kf >= 0 else cfg.min_inliers_ok
            if n_good >= accept and (best is None or n_good > best[0]):
                best = (n_good, R, t, obs)
            if n_good >= 50:
                break
        if best is None:
            return False
        _, R, t, obs = best
        R, t, obs, n_inl, _, _ = self._track_local_map(m, R, t, feats, obs)
        if int(n_inl) < cfg.min_inliers_ok:
            return False
        self._last_R, self._last_t = R, t
        self._last_feats = feats
        self._last_obs = obs
        self._velocity = None
        self._last_reloc_frame_id = frame_id
        return True

    def _reloc_widen(self, feats: FrameFeatures, kf: int, R, t, obs, n_good: int):
        """Relocalization's projective widening from candidate kf: a coarse
        window (10 px, descriptor 100), and if that reaches 50 and leaves
        30 to 50 inliers a narrow one (3 px, 64). Returns (R, t, obs,
        n_good)."""
        cfg = self.cfg
        m = self.map
        for window, max_desc in ((10.0, 100), (3.0, 64)):
            obs, n_add = steps.reloc_search_by_projection(
                cfg.cam, m, kf, R, t, feats, obs, scale_factor=cfg.orb.scale_factor,
                n_levels=cfg.orb.n_levels, window=window, max_desc_dist=max_desc)
            if n_good + int(n_add) < 50:
                break
            R, t, obs, n_inl = steps.optimize_frame_pose(cfg.cam, m, feats, obs, R, t, self.inv_sigma2)
            n_good = int(n_inl)
            if not 30 < n_good < 50:
                break
        return R, t, obs, n_good

    # ------------------------------------------ localization-mode tracking

    def _track_frame_localization(self, feats: FrameFeatures, frame_id: int) -> bool:
        """Localization-only tracking of a depth sensor's frame with temporal
        visual-odometry points (Tracking.cc:343-421): the motion model
        tracks the last frame's map points and, where it holds none, the VO
        points made from its close depths; while the last frame tracked
        mostly VO points (mbVO) relocalization also runs, and wins when it
        succeeds. TrackLocalMap runs only outside mbVO."""
        cfg = self.cfg
        m = self.map
        last = self._last_feats
        tag0 = self._last_obs
        has_map = (tag0 >= 0) & last.valid & m.pt_valid[tag0.clamp(min=0).long()]
        xyz = m.pt_xyz[tag0.clamp(min=0).long()]
        tags = torch.where(has_map, tag0, -1)
        has = has_map
        if self._vo_xyz is not None:
            vo = self._vo_valid & ~has_map & last.valid
            xyz = torch.where(vo[:, None], self._vo_xyz, xyz)
            has = has_map | vo

        def run_motion_model():
            R_pred, t_pred = self._predict_pose()
            for th in (7.0, 14.0):
                R, t, ct, cx, n_map, n_tot, n_m = steps.track_motion_model_pts(
                    cfg.cam, last, xyz, tags, has, R_pred, t_pred, feats, self.inv_sigma2,
                    scale_factor=cfg.orb.scale_factor, n_levels=cfg.orb.n_levels, th=th)
                n_m, n_tot, n_map = self._fetch(n_m, n_tot, n_map)
                # >= 20 matches before the optimization, > 20 map + VO inliers.
                if n_m >= 20 and n_tot > 20:
                    return R, t, ct, cx, int(n_map)
            return None

        mm = None
        used_reloc = False
        if not self._vo_mode:
            mm = run_motion_model() if self._velocity is not None else None
            if mm is None and self._last_kf_idx >= 0:
                R, t, obs, n_matches, n_inl = steps.track_reference_keyframe(
                    cfg.cam, m, self._last_kf_idx, feats, self._last_R, self._last_t,
                    self.inv_sigma2)
                n_matches, n_inl = self._fetch(n_matches, n_inl)
                if n_matches >= 15 and n_inl >= 10:
                    ct = torch.where(obs >= 0, obs, -2)
                    cx = torch.where((obs >= 0)[:, None], m.pt_xyz[obs.clamp(min=0).long()], 0.0)
                    mm = (R, t, ct, cx, int(n_inl))
        else:
            # mbVO: the motion model and relocalization both; relocalization wins.
            mm = run_motion_model() if self._velocity is not None else None
            with self._stage("track.relocalize"):
                used_reloc = self._relocalize(feats, frame_id)
            if used_reloc:
                self._vo_mode = False
        if not used_reloc and mm is None:
            return False

        if used_reloc:
            # _relocalize polished the pose with TrackLocalMap and set the
            # frame state; only the VO bookkeeping is left.
            R, t = self._last_R, self._last_t
            cur_tag = torch.where(self._last_obs >= 0, self._last_obs, -2)
            cur_xyz = torch.zeros((feats.xy.shape[0], 3), device=self.device)
            self._record_pose(frame_id, R, t)
        else:
            R, t, cur_tag, cur_xyz, n_map = mm
            self._vo_mode = n_map < 10
            if not self._vo_mode:
                # TrackLocalMap over the frozen map; VO matches stay out of it.
                obs_map = torch.where(cur_tag >= 0, cur_tag, -1)
                R, t, obs_map, n_inl, visible, found = self._track_local_map(m, R, t, feats, obs_map)
                if int(n_inl) < cfg.min_inliers_ok:
                    return False
                self.map = self.map._replace(
                    pt_visible=self.map.pt_visible + visible.to(torch.float32),
                    pt_found=self.map.pt_found + found.to(torch.float32))
                cur_tag = torch.where(obs_map >= 0, obs_map, torch.where(cur_tag == -1, -1, -2))
            self._velocity = se3_compose(R, t, *se3_inverse(self._last_R, self._last_t))
            self._last_R, self._last_t = R, t
            self._last_feats = feats
            self._last_obs = torch.where(cur_tag >= 0, cur_tag, -1).to(torch.int32)
            self._record_pose(frame_id, R, t)
        self._frames_since_kf += 1
        self._update_vo_points(feats, cur_tag, cur_xyz, R, t)
        return True

    def _update_vo_points(self, feats: FrameFeatures, cur_tag, cur_xyz, R, t):
        """The next frame's VO points (Tracking::UpdateLastFrame): the
        keypoints with depth that track no map point, every one closer than
        th_depth and the 100 nearest in any case, unprojected into the world;
        a carried VO match (tag -1) keeps its position."""
        d = feats.depth
        has_d = (d > 0) & feats.valid
        order_d = torch.where(has_d, d, float("inf"))
        # The rank of each depth, ties by index (jnp.argsort is stable).
        rank = torch.argsort(torch.argsort(order_d, stable=True), stable=True)
        create = has_d & (cur_tag < 0) & ((d < self._th_depth) | (rank < 100))
        Xw = se3_apply(*se3_inverse(R, t), unproject(self.cfg.cam, feats.xy, d))
        carried = cur_tag == -1
        self._vo_xyz = torch.where(carried[:, None], cur_xyz, Xw)
        self._vo_valid = carried | create

    # ------------------------------------------------- stereo / RGB-D input

    @property
    def _th_depth(self) -> float:
        """The close/far depth threshold: th_depth_factor baselines."""
        return self.cfg.th_depth_factor * self.cfg.cam.baseline

    def _frame_features_stereo(self, img_left: torch.Tensor, img_right: torch.Tensor) -> FrameFeatures:
        c = self.cfg.cam
        return steps.stereo_frame_features(img_left, img_right, self.cfg.orb, c.fx, c.bf)

    def _frame_features_rgbd(self, img: torch.Tensor, depth_map: torch.Tensor) -> FrameFeatures:
        """Frame::ComputeStereoFromRGBD: the depth image (scaled by
        depth_map_factor) at each keypoint's raw, distorted position, and
        the virtual right coordinate from the undistorted one. One
        extraction gives both positions."""
        f = extract_orb(img, self.cfg.orb)
        feats = self._mono_features(f)
        c = self.cfg.cam
        H, W = depth_map.shape
        xs = torch.clamp(torch.round(f.xy[:, 0]).long(), 0, W - 1)
        ys = torch.clamp(torch.round(f.xy[:, 1]).long(), 0, H - 1)
        d = depth_map[ys, xs] * self.cfg.depth_map_factor
        has_d = (d > 0) & feats.valid
        # float32(bf) / d, a true division, as the JAX package divides.
        ur = feats.xy[:, 0] - torch.full_like(d, c.bf) / torch.clamp(d, min=1e-6)
        return feats._replace(u_right=torch.where(has_d, ur, -1.0),
                              depth=torch.where(has_d, d, 0.0))

    def _point_ranges(self, dist: torch.Tensor, level: torch.Tensor):
        """MapPoint::UpdateNormalAndDepth's scale-invariance range (the
        creation's 0.8 / 1.2 margins applied) at distance `dist` seen at
        octave `level`."""
        sf = self.scale_factors[torch.clamp(level, 0, self.cfg.orb.n_levels - 1).long()]
        max_d = dist * sf
        min_d = max_d / self.scale_factors[-1]
        return 0.8 * min_d, 1.2 * max_d

    def _initialize_with_depth(self, feats: FrameFeatures, frame_id: int) -> bool:
        """StereoInitialization: one keyframe at the origin, a map point
        unprojected from every keypoint with depth. Needs half the feature
        budget in valid keypoints (the reference's 500 of 1000), and 50 of
        them with depth, so an empty map never enters OK."""
        has_d = (feats.depth > 0) & feats.valid
        n_valid, n_depth = self._fetch(feats.valid.sum(), has_d.sum())
        if n_valid < max(self.cfg.orb.n_features // 2, 50) or n_depth < 50:
            return False
        X = unproject(self.cfg.cam, feats.xy, feats.depth)  # camera frame = world
        n = feats.xy.shape[0]
        normal = X / torch.clamp(torch.linalg.norm(X, dim=-1, keepdim=True), min=1e-9)
        lo, hi = self._point_ranges(torch.linalg.norm(X, dim=-1), feats.level)
        m, slots = insert_points(self.map, X, feats.desc, 0, has_d, normal, lo, hi)
        obs = torch.where(has_d, slots, -1).to(torch.int32)
        obs_p = torch.cat([obs, obs.new_full((self.kp_capacity - n,), -1)])
        eye, zero = torch.eye(3, device=self.device), torch.zeros(3, device=self.device)
        m, _ = insert_keyframe(m, self._pad_feats(feats), eye, zero, frame_id, obs_p)
        self.map = update_point_normals(m, self.scale_factors)
        self._depth_mode = True
        self.state = TrackingState.OK
        self._last_feats = feats
        self._last_obs = obs
        self._last_R, self._last_t = eye, zero
        self._velocity = None
        self._last_kf_idx = 0
        self._frames_since_kf = 0
        self._n_kf_host = 1
        self._record_pose(frame_id, eye, zero)
        return True

    def _add_depth_points(self, m: MapState, ki: int, feats_p: FrameFeatures, R, t) -> MapState:
        """Tracking::CreateNewKeyFrame's densification: a map point for each
        of keyframe ki's untracked keypoints closer than th_depth."""
        obs_kf = m.kf_obs_pt[ki]
        d = feats_p.depth
        free = (obs_kf < 0) & feats_p.valid & (d > 0) & (d < self._th_depth)
        Xc = unproject(self.cfg.cam, feats_p.xy, d)
        Xw = se3_apply(*se3_inverse(R, t), Xc)
        vecs = Xw - (-(R.T @ t))
        normal = vecs / torch.clamp(torch.linalg.norm(vecs, dim=-1, keepdim=True), min=1e-9)
        lo, hi = self._point_ranges(torch.linalg.norm(Xc, dim=-1), feats_p.level)
        m, slots = insert_points(m, Xw, feats_p.desc, ki, free, normal, lo, hi)
        new_obs = torch.where(free & (slots >= 0), slots, obs_kf).to(m.kf_obs_pt.dtype)
        return m._replace(kf_obs_pt=_set(m.kf_obs_pt, ki, new_obs))

    def reset(self):
        """Clear the map and restart at NO_IMAGES_YET (System::Reset)."""
        self.map = self._empty_map()
        self.state = TrackingState.NO_IMAGES_YET
        self.trajectory = []
        self.n_recycled_kf_slots = 0
        if self.loop_closer is not None:  # the vocabulary is kept
            self.loop_closer = self._new_loop_closer(self.loop_closer.voc)
        self._reset_tracking()

    # ------------------------------------------------------------- public API

    def _pose_out(self):
        """The current T_cw on the host, from the packed fetch when fresh."""
        if self._last_pose_np is not None:
            return tuple(np.asarray(x) for x in self._last_pose_np)
        return self._pose_np(self._last_R, self._last_t)

    def track_monocular(self, img: torch.Tensor, frame_id: int):
        """One (H, W) float32 grayscale frame on the tracker's device;
        returns T_cw (R, t) as numpy, or None."""
        self.n_frames += 1
        if self.state in (TrackingState.NO_IMAGES_YET, TrackingState.NOT_INITIALIZED):
            self.state = TrackingState.NOT_INITIALIZED
            if self._try_initialize(self._frame_features(img, init=True), frame_id):
                return self._pose_out()
            return None
        self._last_pose_np = None
        if self.state == TrackingState.OK:
            return self._after_ok_track(self._track_frame(None, frame_id, img=img), frame_id)
        return self._lost_track(self._frame_features(img), frame_id)

    def track_monocular_features(self, feats: FrameFeatures, frame_id: int):
        """track_monocular over precomputed FrameFeatures, once initialized."""
        self.n_frames += 1
        self._last_pose_np = None
        if self.state == TrackingState.OK:
            return self._after_ok_track(self._track_frame(feats, frame_id), frame_id)
        return self._lost_track(feats, frame_id)

    def _after_ok_track(self, ok: bool, frame_id: int):
        if ok:
            return self._pose_out()
        self.state = TrackingState.LOST
        # Lost right after initialization: a map of <= 5 keyframes is not
        # worth relocalizing against; bootstrap again.
        if not self.localization_mode and int(self.map.kf_valid.sum()) <= 5:
            self.reset()
            return None
        self._record_pose(frame_id, self._last_R, self._last_t, lost=True)
        return None

    def _lost_track(self, feats: FrameFeatures, frame_id: int):
        with self._stage("track.relocalize"):
            ok = self._relocalize(feats, frame_id)
        if ok:
            self.state = TrackingState.OK
            self._record_pose(frame_id, self._last_R, self._last_t)
            return self._pose_out()
        self._record_pose(frame_id, self._last_R, self._last_t, lost=True)
        return None

    def track_stereo(self, img_left: torch.Tensor, img_right: torch.Tensor, frame_id: int):
        """One rectified pair of (H, W) float32 images on the tracker's
        device; returns T_cw (R, t) as numpy, or None."""
        with self._stage("track.stereo_features"):
            feats = self._frame_features_stereo(img_left, img_right)
        return self._track_with_depth(feats, frame_id)

    def track_rgbd(self, img: torch.Tensor, depth_map: torch.Tensor, frame_id: int):
        """One (H, W) float32 image and its registered (H, W) float32 depth
        image (raw units, times depth_map_factor gives metres) on the
        tracker's device; returns T_cw (R, t) as numpy, or None."""
        with self._stage("track.rgbd_features"):
            feats = self._frame_features_rgbd(img, depth_map)
        return self._track_with_depth(feats, frame_id)

    def track_depth_features(self, feats: FrameFeatures, frame_id: int):
        """Stereo / RGB-D tracking over precomputed FrameFeatures with
        u_right and depth filled (the multi-stream front end's entry)."""
        return self._track_with_depth(feats, frame_id)

    def _track_with_depth(self, feats: FrameFeatures, frame_id: int):
        self.n_frames += 1
        self._last_pose_np = None
        if self.state in (TrackingState.NO_IMAGES_YET, TrackingState.NOT_INITIALIZED):
            self.state = TrackingState.NOT_INITIALIZED
            if self._initialize_with_depth(feats, frame_id):
                return self._pose_out()
            return None
        if self.state == TrackingState.OK:
            return self._after_ok_track(self._track_frame(feats, frame_id), frame_id)
        return self._lost_track(feats, frame_id)

    def shutdown(self):
        """Mapping runs synchronously: nothing is in flight."""

    def export_trajectory(self):
        """The camera trajectory: each frame's stored relative pose composed
        with its reference keyframe's optimized pose, a culled keyframe
        resolved through its spanning-tree parents. Returns a list of
        (frame_id, R_cw (3, 3), t_cw (3,), lost) as numpy."""
        kf_R = self.map.kf_R.cpu().numpy()
        kf_t = self.map.kf_t.cpu().numpy()
        kf_valid = self.map.kf_valid.cpu().numpy()
        parent = self.map.kf_parent.cpu().numpy()
        rel_R = self.map.kf_rel_R.cpu().numpy()
        rel_t = self.map.kf_rel_t.cpu().numpy()
        eff_R, eff_t = kf_R.copy(), kf_t.copy()
        for k in range(len(kf_R)):
            if kf_valid[k] or parent[k] < 0:
                continue
            A_R, A_t = np.eye(3), np.zeros(3)
            j = k
            for _ in range(len(kf_R)):  # the chain is acyclic; bounded anyway
                if kf_valid[j] or parent[j] < 0:
                    break
                A_R, A_t = A_R @ rel_R[j], A_R @ rel_t[j] + A_t
                j = parent[j]
            eff_R[k] = A_R @ kf_R[j]
            eff_t[k] = A_R @ kf_t[j] + A_t
        out = []
        for frame_id, ref, Rr, tr, lost in self.trajectory:
            if ref >= 0:
                out.append((frame_id, Rr @ eff_R[ref], Rr @ eff_t[ref] + tr, lost))
            else:
                out.append((frame_id, Rr, tr, lost))
        return out
