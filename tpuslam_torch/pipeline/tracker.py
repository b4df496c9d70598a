"""Host-side tracking orchestrator: the state machine of the reference's
Tracking thread over the port's step functions, for monocular, stereo and
RGB-D input. Port of tpuslam/pipeline/tracker.py.

States: NO_IMAGES_YET, NOT_INITIALIZED, OK, LOST. Per frame: ORB
extraction (stereo: both images in one batch, then stereo matching; RGB-D:
the depth image sampled at each keypoint) -> (two-view initialization, or
one keyframe from the depths | the fused tracking step) -> NeedNewKeyFrame
-> LocalMapping (mapping_front), two chunks of local BA and loop closing
(detection, and on a loop the correction and global BA) on each keyframe
-> relocalization when LOST, from the BoW database's keyframe candidates
first. A depth sensor's keyframes add map points from their close depths,
and in localization mode its frames also track visual-odometry points made
from the last frame's depths.

Mapping runs synchronously on each keyframe by default. With
`async_mapping` it runs on a background thread (the reference's
LocalMapping and LoopClosing threads): tracking goes on against the
published snapshot and adopts the job's map at a frame boundary, one job in
flight; a wanted keyframe the busy mapper blocks signals InterruptBA, which
skips the job's second local-BA chunk; global BA after a loop closure runs
on a third thread, in chunks that a newer closure aborts, and its result is
merged into the map as it stands then. With `mapping_process` the mapping
thread ships each snapshot to a worker process
(parallel/mapping_worker.py). With `dist_ba_devices >= 2` global and local
BA run point-sharded over a mesh of devices (parallel/dist_ba.py). On a
card each background thread has its own CUDA stream: it waits for the
publishing stream before it reads a snapshot, synchronizes its stream
before it returns, and what it made is marked with the reading stream
(`record_stream`) when it is adopted.

The device is the tracker's (`device`, "cuda" unless the caller asks for
the CPU). The steady-state frame step, the depth sensors' front ends,
keyframe insertion, relocalization (all but the BoW query, the
brute-force match and EPnP's cuSOLVER calls) and localization mode's
visual odometry go through `StepGraphs` (pipeline/graphs.py;
`tracker.graphs`): on a card each segment is a captured CUDA graph,
replayed at each later call; on the CPU the segments run on the same
static buffers. The keyframe job (mapping_front, both local-BA chunks,
the normals, point compaction) goes through a second StepGraphs,
`tracker.map_graphs`, which only the thread running the job uses. The
global BA's LM iterations (optim/ba.py's lm_step) replay through the
calling thread's StepGraphs: the initial one through `graphs`, a
closure's through `map_graphs` (it runs in the keyframe job) and the GBA
thread's through a third, `tracker.gba_graphs`; the loop closer keeps its
own for the essential graph (LoopCloser.graphs). `tracker.map_graphs.run
= steps.call_segment` runs the job eagerly (and the same on `graphs`,
`gba_graphs`, or `LoopCloser.cg_run`). A steady-state frame makes one
packed device->host fetch beyond the step's own verdict read; keyframe
slots are assigned on the host, so insertion never reads the device
watermark.
Random hypotheses (two-view and PnP RANSAC) come from a torch.Generator
the tracker owns, seeded from its config, through `_draw_picks`.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import enum
import threading
from typing import Optional

import numpy as np
import torch

from tpuslam_torch.geometry.camera import PinholeCamera, unproject
from tpuslam_torch.geometry.se3 import se3_apply, se3_compose, se3_inverse
from tpuslam_torch.mapstate.core import (
    FrameFeatures,
    MapState,
    _nanmedian_last,
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
from tpuslam_torch.optim.linalg import load_cuda_linalg
from tpuslam_torch.pipeline import steps
from tpuslam_torch.pipeline._index import edge_bucket, nonzero_static, scatter_last
from tpuslam_torch.pipeline.graphs import StepGraphs
from tpuslam_torch.pipeline.loop_closing import LoopCloser
from tpuslam_torch.place.database import SparseBow, SparseKeyFrameDatabase
from tpuslam_torch.place.vocabulary import sparse_bow_vector, vocabulary_from_arrays
from tpuslam_torch.sfm.initializer import draw_picks, initialize_two_view
from tpuslam_torch.sfm.pnp import pnp_ransac
from tpuslam_torch.utils.metrics import Metrics, traced


class TrackingState(enum.Enum):
    NO_IMAGES_YET = 0
    NOT_INITIALIZED = 1
    OK = 2
    LOST = 3


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    """The JAX package's TrackerConfig, every field and default but one,
    plus the seed of the tracker's hypothesis generator. The exception:
    the mapping process runs on the card by default (a card takes both
    processes; the JAX package kept its worker on the CPU because one
    process owns a TPU chip)."""

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
    # Mapping and loop closing on a background thread; in a worker process
    # (which implies the thread) on mapping_process_platform, "cuda" or "cpu".
    async_mapping: bool = False
    mapping_process: bool = False
    mapping_process_platform: str = "cuda"
    # TrackLocalMap local-subset cap (0 = 16384 when max_points > 16384).
    local_map_max_pts: int = 0
    # >= 2: global and local BA point-sharded over that many devices (a
    # CUDA tracker's first cards, a CPU tracker's CPU repeated).
    dist_ba_devices: int = 0
    # Seed of the torch.Generator that draws the RANSAC hypotheses.
    seed: int = 0


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
        if config.mapping_process_platform not in ("cuda", "cpu"):
            raise ValueError(f"mapping_process_platform must be 'cuda' or 'cpu', "
                             f"not {config.mapping_process_platform!r}")
        self.cfg = config
        self.device = torch.device(device)
        # The BA mesh (dist_ba_devices >= 2): a CUDA tracker's first cards,
        # a CPU tracker's CPU repeated.
        self._ba_mesh = None
        if config.dist_ba_devices >= 2:
            n = config.dist_ba_devices
            if self.device.type == "cuda":
                visible = torch.cuda.device_count()
                if visible < n:
                    raise ValueError(f"dist_ba_devices={n} but only {visible} devices are visible")
                self._ba_mesh = [torch.device("cuda", i) for i in range(n)]
            else:
                self._ba_mesh = [self.device] * n
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
        # Stages, spans and counters; its stage_sync and tracing are the
        # tracker's (the properties below).
        self.metrics = Metrics(self.device)
        self._kind = "none"  # how the current frame was tracked: the frame span's kind
        # graph_replays: steady-state frames whose step ran as graph
        # replays; graph_captures: graphs captured. map_jobs: keyframe
        # jobs (_mapping_compute); map_graph_replays: those whose segments
        # all replayed; map_graph_captures: the mapping graphs captured
        # (map_graphs' captures, a closure's global BA included). gba_iters:
        # global-BA LM iterations; gba_graph_replays: those replayed as
        # graphs (all of them on a card); gba_graph_captures: the global
        # BA's captures.
        self.stats = {"dispatches": 0, "graph_replays": 0, "graph_captures": 0, "map_jobs": 0,
                      "map_graph_replays": 0, "map_graph_captures": 0, "gba_iters": 0,
                      "gba_graph_replays": 0, "gba_graph_captures": 0}
        # The tracking thread's segments (frame step, keyframe insertion,
        # relocalization, the initial global BA), the mapping job's (on the
        # mapping thread under async_mapping; a closure's global BA too) and
        # the GBA thread's: one StepGraphs per thread.
        self._new_graphs()
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
        # Background mapping (one job in flight, SetAcceptKeyFrames) and the
        # abortable global BA: a generation counter plays mnFullBAIdx, and a
        # result of a superseded generation is discarded.
        self._mapping_pool = self._gba_pool = None
        self._mapping_future = self._gba_future = None
        self._gba_generation = 0
        # InterruptBA (mbAbortBA): set when a keyframe is wanted while the
        # mapper is busy; the job then skips its second local-BA chunk.
        self._mapping_interrupt = threading.Event()
        self._map_stream = self._gba_stream = None
        self._remote_mapper = None
        if config.async_mapping or config.mapping_process:
            self._mapping_pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="local-mapping")
            self._gba_pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="global-ba")
            if self.device.type == "cuda":
                self._map_stream = torch.cuda.Stream(self.device)
                self._gba_stream = torch.cuda.Stream(self.device)
                load_cuda_linalg(self.device)  # its lazy load is not thread-safe
        if config.mapping_process:
            # The worker owns the loop-closing state and runs global BA
            # inline; this tracker's closer mirrors its BoW rows.
            from tpuslam_torch.parallel.mapping_worker import RemoteMappingWorker

            self._remote_mapper = RemoteMappingWorker(config, device=config.mapping_process_platform)
        self._reset_tracking()

    def __getstate__(self):
        """copy.deepcopy (and pickle) take an idle tracker's state without
        its background machinery (threads, streams, the interrupt event,
        the mapping process) and without its captured graphs: the copy maps
        synchronously and captures its own."""
        state = dict(self.__dict__)
        for k in ("_mapping_pool", "_gba_pool", "_mapping_future", "_gba_future", "_map_stream",
                  "_gba_stream", "_remote_mapper", "_mapping_interrupt", "graphs", "map_graphs",
                  "gba_graphs"):
            state[k] = None
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._mapping_interrupt = threading.Event()
        self._new_graphs()

    def _new_graphs(self):
        self.graphs = StepGraphs(self.device, self.metrics)
        self.map_graphs = StepGraphs(self.device, self.metrics, stage="map.capture")
        self.gba_graphs = StepGraphs(self.device, self.metrics, stage="gba.capture")

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
        packed = torch.stack([torch.as_tensor(s).to(torch.float32) for s in scalars])
        with traced("read.scalars"):
            return packed.cpu().numpy()

    @property
    def stage_sync(self) -> bool:
        """Each stage synchronizes the calling thread's stream at its end,
        so its sample holds device time (the flag is the recorder's, shared
        with the loop closer). On, it turns tracing on too."""
        return self.metrics.stage_sync

    @stage_sync.setter
    def stage_sync(self, on: bool):
        self.metrics.stage_sync = on

    @property
    def tracing(self) -> bool:
        """The recorder keeps spans with parents, frame kinds, the graphs'
        replays, the host's reads and the uploads, and on a card each
        span's device time from an event pair, without synchronizing
        (utils/metrics.py). Off, each such site costs one attribute test."""
        return self.metrics.tracing

    @tracing.setter
    def tracing(self, on: bool):
        self.metrics.tracing = on

    def _stage(self, name: str):
        """Time a stage; with stage_sync, the calling thread's stream is
        synchronized at its end (Metrics.span)."""
        return self.metrics.span(name, sync=True)

    @contextlib.contextmanager
    def _frame(self, frame_id: int):
        """A frame's root span (tracing on, and none open yet: System opens
        it around the uploads). Its kind, set as it ends: how the frame was
        tracked (_kind: mm, ref, retry, reloc, lost, init), with ".kf" when
        a keyframe was inserted."""
        kf0 = self.metrics.counters.get("frames.keyframe", 0)
        with self.metrics.frame(frame_id) as f:
            yield
            if f is not None:
                kf = self.metrics.counters.get("frames.keyframe", 0) > kf0
                f.kind = self._kind + (".kf" if kf else "")

    def _ready_event(self):
        """An event on the calling thread's stream (None on the CPU): a
        background job's stream waits on it before it reads what the caller
        published."""
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    @contextlib.contextmanager
    def _on_stream(self, stream, ready):
        """A background job's work on its own stream: after the publisher's
        work (`ready`), and finished when the block ends (the stream
        synchronized), so what it returns is complete and what it read may
        be freed."""
        if stream is None:
            yield
            return
        with torch.cuda.device(self.device), torch.cuda.stream(stream):
            stream.wait_event(ready)
            try:
                yield
            finally:
                stream.synchronize()

    def _hand_over(self, *tensors):
        """Mark tensors another stream made as used on the calling thread's
        stream, so that once freed their memory is not reused while this
        stream's kernels may still read them."""
        if self._map_stream is None:
            return
        s = torch.cuda.current_stream(self.device)
        for x in tensors:
            if isinstance(x, torch.Tensor) and x.is_cuda:
                x.record_stream(s)

    def _mono_features(self, f) -> FrameFeatures:
        """FrameFeatures of one image's ORBFeatures: undistorted xy, no depth."""
        return steps.mono_features(self.cfg.cam, f)

    def _frame_features(self, img: torch.Tensor, init: bool = False) -> FrameFeatures:
        return self._mono_features(extract_orb(img, self._init_orb if init else self.cfg.orb))

    def _pad_feats(self, feats: FrameFeatures) -> FrameFeatures:
        return pad_feats(feats, self.kp_capacity)

    @staticmethod
    def _pose_np(R: torch.Tensor, t: torch.Tensor):
        """(R, t) on the host in one device->host read."""
        packed = torch.cat([R.reshape(-1), t.reshape(-1)])
        with traced("read.pose"):
            p = packed.cpu().numpy()
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
        lo, hi = steps.point_ranges(self.scale_factors, torch.linalg.norm(r2v, dim=-1), cur.level[idx])
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

    def _global_ba(self, m: MapState, iters: int = 20, graphs: Optional[StepGraphs] = None) -> MapState:
        """Global BA over every observation of the map, keyframe 0 fixed,
        its LM iterations through `graphs` (the calling thread's
        StepGraphs; the tracking thread's by default). The solver takes the
        live edges only (one read: their count), where the JAX package
        passes all K*N slots with the dead ones at zero weight: the same
        sums, in another order. The live edges come first, in slot order,
        padded to edge_bucket(count) with edges parked out of range (kf =
        K, pt = P), so a card replays one graph per (K, P, bucket, CG
        iterations), and the padded solve equals the unpadded one bit for
        bit on the CPU. With a BA mesh the solve is point-sharded, eager
        and unpadded."""
        K, N = m.kf_obs_pt.shape
        P = m.capacity_pt
        dev = self.device
        kfi = torch.arange(K, dtype=torch.int32, device=dev).repeat_interleave(N)
        pti = m.kf_obs_pt.reshape(-1)
        has = (pti >= 0) & m.kf_kp_valid.reshape(-1) & m.kf_valid[kfi.long()]
        live_mask = has & m.pt_valid[pti.clamp(min=0).long()]
        uvr = torch.cat([m.kf_kp_xy.reshape(K * N, 2), m.kf_kp_uright.reshape(K * N, 1)], dim=-1)
        lvl = torch.clamp(m.kf_kp_level.reshape(-1), 0, self.inv_sigma2.shape[0] - 1).long()
        common = dict(R=m.kf_R, t=m.kf_t, X=m.pt_xyz, fixed_kf=~m.kf_valid | (torch.arange(K, device=dev) == 0),
                      fixed_pt=~m.pt_valid)
        if self._ba_mesh is not None:
            live = torch.nonzero(live_mask)[:, 0]
            prob = BAProblem(kf=kfi[live], pt=pti[live], uvr=uvr[live], inv_sigma2=self.inv_sigma2[lvl[live]],
                             valid=torch.ones(live.shape, dtype=torch.bool, device=dev), **common)
            R, t, X, _ = self._run_ba(prob, iters=iters)
            return m._replace(kf_R=R, kf_t=t, pt_xyz=X)
        live = nonzero_static(live_mask, edge_bucket(int(live_mask.sum())), K * N)
        pad = live == K * N
        at = live.clamp(max=K * N - 1)
        prob = BAProblem(kf=torch.where(pad, K, kfi[at]), pt=torch.where(pad, P, pti[at]),
                         uvr=torch.where(pad[:, None], 0.0, uvr[at]),
                         inv_sigma2=torch.where(pad, 0.0, self.inv_sigma2[lvl[at]]), valid=~pad, **common)
        g = self.graphs if graphs is None else graphs
        replays, captures = g.replays, g.captures
        R, t, X, _ = bundle_adjustment(self.cfg.cam, prob, iters=iters, run=g.run)
        self.stats["gba_iters"] += iters
        self.stats["gba_graph_replays"] += g.replays - replays
        self.stats["gba_graph_captures"] += g.captures - captures
        return m._replace(kf_R=R, kf_t=t, pt_xyz=X)

    def _run_ba(self, prob: BAProblem, iters: int):
        """The point-sharded solver over the BA mesh (point blocks and their
        edges per device, the pose system summed over the shards): it
        reaches the single-device solver's stationary points."""
        from tpuslam_torch.parallel.dist_ba import point_sharded_bundle_adjustment

        return point_sharded_bundle_adjustment(self.cfg.cam, prob, self._ba_mesh, iters=iters,
                                               cg_iters=self.cfg.local_ba_cg_iters)

    def _local_ba(self, m: MapState, center_kf: int, iters: int = 8) -> MapState:
        """Local BA around keyframe center_kf: steps.local_ba_segment through
        the mapping graphs on one device; with a mesh (eager) the same
        covisibility window over all K*N observation slots, solved
        point-sharded, then the same chi2 outlier detach (5.991 mono /
        7.815 stereo)."""
        cfg = self.cfg
        if self._ba_mesh is None:
            return steps.merge_fields(m, self.map_graphs.run(
                "local_ba", steps.local_ba_segment,
                dict(cam=cfg.cam, window=cfg.local_ba_window, n_levels=cfg.orb.n_levels, iters=iters,
                     max_edges=cfg.local_ba_max_edges or 32 * cfg.orb.n_features,
                     active_max=cfg.local_ba_active_max),
                m=steps.map_fields(m, steps.LOCAL_BA_FIELDS), center_kf=self._index(center_kf),
                inv_sigma2_table=self.inv_sigma2))
        K, N = m.kf_obs_pt.shape
        kfi, pti, uvr, has, fixed_kf, fixed_pt = steps.build_local_ba_problem(m, center_kf, cfg.local_ba_window)
        lvl = torch.clamp(m.kf_kp_level.reshape(-1), 0, self.inv_sigma2.shape[0] - 1).long()
        prob = BAProblem(R=m.kf_R, t=m.kf_t, X=m.pt_xyz, kf=kfi, pt=pti, uvr=uvr,
                         inv_sigma2=self.inv_sigma2[lvl], valid=has & m.pt_valid[pti.long()],
                         fixed_kf=fixed_kf, fixed_pt=fixed_pt)
        R, t, X, chi2 = self._run_ba(prob, iters=iters)
        bad = prob.valid & (chi2 > torch.where(uvr[:, 2] >= 0, 7.815, 5.991))
        obs = torch.where(bad, -1, m.kf_obs_pt.reshape(-1))
        return m._replace(kf_R=R, kf_t=t, pt_xyz=X, kf_obs_pt=obs.reshape(K, N))

    # ------------------------------------------- global BA (async, abortable)

    def _gba_job(self, m_snap: MapState, gen: int, iters: int, ready, graphs: StepGraphs):
        """Global BA over a map snapshot on the GBA thread (its LM iterations
        through `graphs`, the GBA thread's), in chunks of 5 LM iterations
        (`iters` rounded up to a multiple); a newer generation aborts it
        between chunks (mbStopGBA). Returns (R, t, X, gen, the snapshot's
        keyframe frame ids, validity and point watermark), or None when
        aborted."""
        chunk = 5
        with self._on_stream(self._gba_stream, ready):
            mm = m_snap
            done = 0
            while done < iters:
                if gen != self._gba_generation:
                    return None
                mm = self._global_ba(mm, iters=chunk, graphs=graphs)
                done += chunk
            return mm.kf_R, mm.kf_t, mm.pt_xyz, gen, m_snap.kf_frame_id, m_snap.kf_valid, m_snap.n_pt

    def _schedule_gba(self, m: MapState, iters: int = 10) -> MapState:
        """Global BA for a freshly corrected loop: synchronous without the
        background threads (through the mapping job's graphs: it runs in
        the job), else handed to the GBA thread (a running one is superseded
        by the generation bump and stops at its next chunk) and the map
        returned as it is."""
        self._gba_generation += 1
        if self._gba_pool is None:
            return self._global_ba(m, iters=iters, graphs=self.map_graphs)
        self._gba_future = self._gba_pool.submit(self._gba_job, m, self._gba_generation, iters,
                                                 self._ready_event(), self.gba_graphs)
        return m

    def _poll_gba(self, m: MapState) -> MapState:
        """Merge a finished global BA into the map as it stands (the
        spanning-tree propagation of LoopClosing::RunGlobalBundleAdjustment):
        snapshot keyframes, matched by frame id (a recycled slot holds
        another keyframe), take the optimized poses; later keyframes follow
        the newest snapshot keyframe; points made after the snapshot keep
        their camera coordinates in their reference keyframe. A superseded
        generation leaves the map unchanged. No device->host read."""
        f = self._gba_future
        if f is None or not f.done():
            return m
        self._gba_future = None
        res = f.result()
        if res is None:
            return m
        R_g, t_g, X_g, gen, snap_fid, snap_valid, n_pt_s = res
        if gen != self._gba_generation:
            return m
        self._hand_over(R_g, t_g, X_g, snap_fid, snap_valid, n_pt_s)
        K = m.capacity_kf
        anchor = torch.argmax(torch.where(snap_valid, snap_fid, -1))
        R_post, t_post = se3_compose(*se3_compose(m.kf_R, m.kf_t, *se3_inverse(m.kf_R[anchor], m.kf_t[anchor])),
                                     R_g[anchor], t_g[anchor])
        pre_k = (m.kf_frame_id == snap_fid)[:, None]
        R_new = torch.where(pre_k[..., None], R_g, R_post)
        t_new = torch.where(pre_k, t_g, t_post)
        ref = torch.clamp(m.pt_ref_kf, 0, K - 1).long()
        Xc = se3_apply(m.kf_R[ref], m.kf_t[ref], m.pt_xyz)
        X_post = se3_apply(*se3_inverse(R_new[ref], t_new[ref]), Xc)
        pre_p = (torch.arange(m.capacity_pt, device=m.pt_xyz.device) < n_pt_s)[:, None]
        return m._replace(kf_R=R_new, kf_t=t_new, pt_xyz=torch.where(pre_p, X_g, X_post))

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
        subset on a large map: steps.polish_segment through the graphs."""
        cfg = self.cfg
        return self.graphs.run(
            "polish", steps.polish_segment,
            dict(cam=cfg.cam, scale_factor=cfg.orb.scale_factor, n_levels=cfg.orb.n_levels,
                 max_local_pts=self._local_subset_cap(), cand_cap=self._cand_cap()),
            m=steps.map_fields(m, steps.POLISH_MAP_FIELDS), ref_kf=self._index(self._last_kf_idx),
            feats=feats, R=R, t=t, obs=obs, inv_sigma2_table=self.inv_sigma2)

    def _index(self, i: int) -> torch.Tensor:
        """A keyframe slot as a 1-element index tensor (a segment's input;
        a negative slot is 0)."""
        return torch.full((1,), max(int(i), 0), dtype=torch.int64, device=self.device)

    def _optimize_pose(self, feats, obs, R, t):
        """steps.optimize_frame_pose through the graphs: (R, t, obs, n_inl)."""
        return self.graphs.run("pose", steps.optimize_frame_pose, dict(cam=self.cfg.cam),
                               m=steps.map_fields(self.map, steps.POSE_MAP_FIELDS), cur=feats,
                               obs_pt=obs, R0=R, t0=t, inv_sigma2_table=self.inv_sigma2)

    def _predict_pose(self):
        if self._velocity is not None:
            return se3_compose(*self._velocity, self._last_R, self._last_t)
        return self._last_R, self._last_t

    def _accept_thr(self, frame_id: int) -> int:
        """TrackLocalMap's inlier bar: 50 within kf_max_frames of a
        relocalization."""
        cfg = self.cfg
        if frame_id < self._last_reloc_frame_id + cfg.kf_max_frames:
            return max(cfg.min_inliers_ok, 50)
        return cfg.min_inliers_ok

    def _track_frame(self, feats: Optional[FrameFeatures], frame_id: int,
                     img: Optional[torch.Tensor] = None) -> bool:
        """The steady-state frame: the step's segments (from the image, with
        the front end ahead, when `img` is given) replayed from their
        graphs on a card, and one packed fetch. A motion-model estimate
        that TrackLocalMap rejects is retried through the reference
        keyframe. A finished background mapping job is adopted first."""
        self._poll_mapping()
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
                      max_local_pts=self._local_subset_cap(), cand_cap=self._cand_cap(),
                      run=self.graphs.run)
        # A frame from the image tracks as fused_track_frame_image does (no
        # depth gates), the slow-frame retry too.
        th_depth, depth = (0.0, False) if img is not None else (self._th_depth, self._depth_mode)
        replays = self.graphs.replays
        with self.metrics.span("track.dispatch"):
            if img is not None:
                feats, *out = steps.fused_track_frame_image(
                    cfg.cam, cfg.orb, self.map, img, self._last_feats, self._last_obs,
                    self._last_R, self._last_t, vel_R, vel_t, has_vel, ref, self.inv_sigma2,
                    float(thr), **common)
            else:
                out = steps.fused_track_frame(
                    cfg.cam, self.map, self._last_feats, self._last_obs, self._last_R,
                    self._last_t, vel_R, vel_t, has_vel, feats, ref, self.inv_sigma2,
                    th_depth, float(thr), scale_factor=cfg.orb.scale_factor,
                    n_levels=cfg.orb.n_levels, depth=depth, **common)
        R, t, obs, vel_R2, vel_t2, pt_visible, pt_found, packed = out
        self.stats["dispatches"] += 1
        self.stats["graph_replays"] += self.graphs.replays > replays
        self.stats["graph_captures"] = self.graphs.captures
        with self.metrics.span("track.fetch"), self.metrics.trace("read.fetch"):
            p = packed.cpu().numpy()  # the per-frame device->host read
        used_mm = p[steps.FUSED_USED_MM] > 0.5
        self.metrics.inc("frames.motion_model" if used_mm else "frames.reference_kf")

        if p[steps.FUSED_ACCEPT] > 0.5:
            self._kind = "mm" if used_mm else "ref"
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

        if used_mm and self._last_kf_idx >= 0:
            # The motion model passed its gates on a few aliased matches but
            # TrackLocalMap rejected the pose: retry through the reference
            # keyframe (the step without a velocity) before declaring LOST.
            R, t, obs, vel_R2, vel_t2, pt_visible, pt_found, packed = steps.fused_track_frame(
                cfg.cam, self.map, self._last_feats, self._last_obs, self._last_R, self._last_t,
                torch.eye(3, device=dev), torch.zeros(3, device=dev), False, feats, ref,
                self.inv_sigma2, th_depth, float(thr), scale_factor=cfg.orb.scale_factor,
                n_levels=cfg.orb.n_levels, depth=depth, **common)
            with self.metrics.trace("read.fetch"):
                p = packed.cpu().numpy()
            if p[steps.FUSED_ACCEPT] > 0.5:
                self._kind = "retry"
                n_tracked = int(p[steps.FUSED_N_TRACKED])
                self.map = self.map._replace(pt_visible=pt_visible, pt_found=pt_found)
                self._velocity = (vel_R2, vel_t2)
                self._last_R, self._last_t = R, t
                self._last_feats = feats
                self._last_obs = obs
                self._frames_since_kf += 1
                self._last_pose_np = None
                if self._need_new_keyframe(n_tracked, frame_id,
                                           p[steps.FUSED_GATES:steps.FUSED_GATES + 4]):
                    self._create_keyframe(feats, obs, R, t, frame_id)
                self._record_pose(frame_id, self._last_R, self._last_t)
                return True
        return False

    def _need_new_keyframe(self, n_tracked: int, frame_id: int, gates) -> bool:
        """NeedNewKeyFrame, the full policy: not right after a relocalization
        on an established map; then the cadence (c1a kf_max_frames; c1b
        kf_min_frames with LocalMapping idle) or, for a depth sensor, weak
        tracking (c1c: under a quarter of the reference's points, or the
        close-point pressure need_close: < 100 close points tracked and > 70
        untracked), and the reference ratio (0.4 below two keyframes, else
        kf_ref_ratio, or kf_ref_ratio_depth for a depth sensor) or
        need_close, with more than 15 tracked points. With synchronous
        mapping the mapper is always idle. A wanted keyframe that a busy
        mapper blocks signals InterruptBA; while it is busy a depth sensor
        still inserts (through the join in _create_keyframe), monocular
        only at the c1a hard limit (the reference drops the keyframe;
        dropping it forever when mapping is slower than the camera would
        end in LOST). `gates` is the keyframe_gates pack, already on the
        host."""
        cfg = self.cfg
        if self.localization_mode:
            return False
        n_kf = int(gates[0])
        if frame_id < self._last_reloc_frame_id + cfg.kf_max_frames and n_kf > cfg.kf_max_frames:
            return False
        ref_matches = int(gates[1])
        depth = self._depth_mode
        idle = self._mapping_future is None or self._mapping_future.done()
        need_close = depth and gates[2] < 100 and gates[3] > 70
        if n_kf < 2:
            th_ref = 0.4
        else:
            th_ref = cfg.kf_ref_ratio_depth if depth else cfg.kf_ref_ratio
        c1a = self._frames_since_kf >= cfg.kf_max_frames
        c1b = self._frames_since_kf >= cfg.kf_min_frames and idle
        c1c = depth and (n_tracked < 0.25 * ref_matches or need_close)
        c2 = (n_tracked < th_ref * ref_matches or need_close) and n_tracked > 15
        if not ((c1a or c1b or c1c) and c2):
            if not idle and c2 and self._frames_since_kf >= cfg.kf_min_frames:
                self._signal_mapping_interrupt()
            return False
        if idle:
            return True
        self._signal_mapping_interrupt()
        return bool(depth or c1a)

    def _signal_mapping_interrupt(self):
        """InterruptBA: the in-flight job skips its optional work (the
        second local-BA chunk); a mapping process gets it over its pipe."""
        self.metrics.inc("map.interrupts")
        self._mapping_interrupt.set()
        if self._remote_mapper is not None:
            self._remote_mapper.interrupt()

    # ------------------------------------------------- keyframes and slots

    def _create_keyframe(self, feats, obs, R, t, frame_id):
        n = feats.xy.shape[0]
        if n < self.kp_capacity:
            feats = self._pad_feats(feats)
            obs = torch.cat([obs, obs.new_full((self.kp_capacity - n,), -1)])
        # Back-pressure: one mapping job in flight; its map is adopted before
        # the keyframe is inserted on top of it.
        if self._mapping_future is not None and not self._mapping_future.done():
            self.metrics.inc("map.insert_waits")
            with self.metrics.span("map.insert_wait", timed=False):
                self._join_mapping()
        else:
            self._join_mapping()
        slot = None
        if self._n_kf_host >= self.map.capacity_kf:
            slot = self._recycle_kf_slot()
            if slot is None:
                return  # full, nothing recyclable
        ki = self._n_kf_host if slot is None else slot
        # Insertion (and a depth sensor's new points) as a segment through
        # the tracking thread's graphs: the frame id and slot as tensors.
        fields = steps.KF_INSERT_FIELDS + (steps.POINT_FIELDS if self._depth_mode else ())
        m = steps.merge_fields(self.map, self.graphs.run(
            "kf_insert", steps.kf_insert_segment,
            dict(cam=self.cfg.cam, recycled=slot is not None, depth=self._depth_mode,
                 th_depth=float(self._th_depth)),
            m=steps.map_fields(self.map, fields), feats=feats, R=R, t=t,
            frame_id=torch.full((1,), frame_id, dtype=torch.int32, device=self.device), obs=obs,
            ki=self._index(ki), scale_factors=self.scale_factors))
        if slot is None:
            self._n_kf_host += 1
        self.metrics.inc("frames.keyframe")
        if self._mapping_pool is not None:
            # Publish the snapshot and hand the mapping work to the
            # background thread; tracking goes on against the snapshot.
            self.map = m
            self._last_kf_idx = ki
            self._frames_since_kf = 0
            self._mapping_future = self._mapping_pool.submit(self._mapping_job, m, ki, self._ready_event())
            return
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

    # ------------------------------------------------- mapping (sync/async)

    def _mapping_job(self, m: MapState, ki: int, ready):
        """One keyframe's mapping on the mapping thread, on its own stream:
        _mapping_compute here, or the worker process's. Returns (map, ki)."""
        with self.metrics.span("map.job", timed=False), self._on_stream(self._map_stream, ready):
            if self._remote_mapper is None:
                return self._mapping_compute(m, ki), ki
            m2, pt_remap, bow_rows, voc_blob = self._remote_mapper.process(m, ki, self._depth_mode)
            if pt_remap is not None:
                self._pending_pt_remap = pt_remap
            self._apply_bow_feedback(bow_rows, voc_blob)
            return m2, ki

    def _apply_bow_feedback(self, bow_rows, voc_blob):
        """Mirror the mapping process's keyframe BoW rows (slot, frame id,
        words, weights) into this tracker's loop closer, with its vocabulary
        (shipped once, in the npz layout), so that relocalization keeps its
        BoW candidates: the reference's Tracking queries the shared
        KeyFrameDatabase."""
        lc = self.loop_closer
        if lc is None or (not bow_rows and voc_blob is None):
            return
        if voc_blob is not None and lc.voc is None:
            lc.voc = vocabulary_from_arrays(voc_blob, self.device)
            lc._tried_default = True
        if lc.voc is None or not bow_rows:
            return
        if lc.db is None:
            lc.db = SparseKeyFrameDatabase(lc.voc.n_words, lc.max_keyframes, bow_rows[0][2].shape[0],
                                           device=self.device)
        for slot, fid, words, weight in bow_rows:
            bow = SparseBow(torch.from_numpy(words).to(self.device), torch.from_numpy(weight).to(self.device))
            lc._bow[slot] = bow
            lc.db.add(slot, bow)
            lc._slot_fid[slot] = fid

    def _adopt_mapping_result(self, result):
        m, _ = result
        self._hand_over(*m, self._pending_pt_remap)
        self.map = m
        self._apply_pt_remap()
        # The job this interrupt targeted is over.
        self._mapping_interrupt.clear()
        # The velocity was estimated against the pre-BA map: carried across
        # the swap it compounds the correction; re-estimate it next frame.
        self._velocity = None

    def _join_mapping(self):
        if self._mapping_future is not None:
            self._adopt_mapping_result(self._mapping_future.result())
            self._mapping_future = None

    def _poll_mapping(self):
        f = self._mapping_future
        if f is not None and f.done():
            self._adopt_mapping_result(f.result())
            self._mapping_future = None

    def _mapping_compute(self, m: MapState, ki: int) -> MapState:
        """The LocalMapping work for new keyframe ki, snapshot -> snapshot
        (on the mapping thread when mapping is asynchronous): a finished
        global BA merged first, point-slot compaction near capacity (which
        makes a running global BA's snapshot stale), mapping_front, local BA
        in two chunks (the second skipped once InterruptBA is signalled),
        the normals, then loop closing when it is on. Everything but the
        global BA's merge and the loop stage runs as segments through
        map_graphs (replayed graphs on a card); the reads are the
        compaction trigger and mapping_front's list lengths."""
        g = self.map_graphs
        runs, replays = g.runs, g.replays
        m = self._poll_gba(m)
        with self.metrics.trace("read.compact"):  # the compaction trigger
            full = int(m.n_pt) >= int(0.95 * m.capacity_pt)
        if full:
            with self._stage("map.compact"):
                m = self._compact(m)
        self._mapping_interrupt.clear()
        with self._stage("map.front"):
            m = self._mapping_front(m, ki)
        with self._stage("map.local_ba1"):
            m = self._local_ba(m, ki, iters=4)
        if self._mapping_interrupt.is_set():
            self.metrics.inc("map.local_ba2_skipped")
        else:
            with self._stage("map.local_ba2"):
                m = self._local_ba(m, ki, iters=4)
        with self._stage("map.normals"):
            m = self._normals(m)
        self.stats["map_jobs"] += 1
        self.stats["map_graph_replays"] += g.runs > runs and g.replays - replays == g.runs - runs
        self.stats["map_graph_captures"] = g.captures
        if self.loop_closer is not None:
            with self._stage("map.loop"):
                m = self._close_loops(m, ki)
        return m

    def _mapping_front(self, m: MapState, ki: int) -> MapState:
        """steps.mapping_front through the mapping graphs. Neighbours and
        the culling's observation bar: 10 and 2 for a depth sensor, 20 and
        3 for a monocular map."""
        cfg = self.cfg
        nn_auto = 10 if self._depth_mode else 20
        return steps.mapping_front(
            cfg.cam, m, self._index(ki), self.inv_sigma2, 2.0 if self._depth_mode else 3.0,
            scale_factor=cfg.orb.scale_factor, n_levels=cfg.orb.n_levels,
            nn_tri=cfg.tri_neighbors or nn_auto, nn_fuse=cfg.fuse_neighbors or nn_auto,
            fuse_hop=cfg.fuse_second_hop, window=cfg.local_ba_window, run=self.map_graphs.run)

    def _normals(self, m: MapState) -> MapState:
        """steps.normals_segment through the mapping graphs."""
        return steps.merge_fields(m, self.map_graphs.run(
            "normals", steps.normals_segment, {}, m=steps.map_fields(m, steps.NORMALS_FIELDS),
            scale_factors=self.scale_factors))

    def _compact(self, m: MapState) -> MapState:
        """Point-slot compaction (steps.compact_segment through the mapping
        graphs); the remap is kept for the tracker's own references, and a
        running global BA's snapshot goes stale."""
        part, self._pending_pt_remap = self.map_graphs.run(
            "compact", steps.compact_segment, {}, m=steps.map_fields(m, steps.COMPACT_FIELDS))
        self._gba_generation += 1
        return steps.merge_fields(m, part)

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

    # --------------------------------------------------------- relocalization

    def _match_frame_to_kf_points(self, feats: FrameFeatures, kf: int):
        """Match the frame's keypoints against keyframe kf's map points (the
        SearchByBoW step of Relocalization; steps.reloc_match_segment
        through the graphs). Returns (pt_idx (N,), ok (N,))."""
        return self.graphs.run(
            "reloc_match", steps.reloc_match_segment, {},
            m=steps.map_fields(self.map, steps.RELOC_MATCH_FIELDS), kf=self._index(kf), feats=feats)

    def _reloc_candidate_kfs(self, feats: FrameFeatures) -> Optional[list]:
        """BoW relocalization candidates (KeyFrameDatabase::
        DetectRelocalizationCandidates): the frame's BoW vector against the
        loop closer's database, with no min-score gate and no covisible
        exclusion. None without a vocabulary or a database."""
        lc = self.loop_closer
        if lc is None or lc.voc is None or lc.db is None:
            return None
        # The database as the mapping thread last published it; on a card,
        # after the mapping stream's work that made it.
        voc, db = lc.voc, lc.db.snapshot()
        if self._map_stream is not None:
            torch.cuda.current_stream(self.device).wait_stream(self._map_stream)
            self._hand_over(db.words, db.weight, db.has, voc.word_weight, *voc.centers,
                            *(voc.centers_valid or ()))
        v = sparse_bow_vector(voc, feats.desc, feats.valid)
        K = self.map.capacity_kf
        idx, ok = db.query(v, torch.zeros(K, dtype=torch.bool, device=self.device),
                           covisibility_weights(self.map), min_score=0.0, max_candidates=3)
        got = torch.stack([idx, ok.to(idx.dtype)]).cpu().numpy()  # one read
        return [int(i) for i, o in zip(*got) if o] or None

    def _relocalize(self, feats: FrameFeatures, frame_id: int) -> bool:
        """Tracking::Relocalization: BoW keyframe candidates -> descriptor
        matching against each candidate's points -> EPnP RANSAC -> pose
        optimization -> up to two rounds of projective widening to reach 50
        inliers -> the local-map polish. Brute-force matching over every map
        point when no candidate yields 15 matches (or there is no database),
        accepted at the configured minimum.

        Each step but the candidates' BoW query and the brute-force match
        (shapes that follow the map; not jitted in the JAX package either)
        runs through the tracker's graphs; EPnP's cuSOLVER calls run eagerly
        between its segments (sfm/pnp.py). The RANSAC picks are drawn
        before, outside any graph. The reads are the eager form's: the
        match counts, the RANSAC verdict, the inlier and added counts."""
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
        K = steps._intrinsics(cfg.cam, self.device)[0]
        for pt_idx, ok, kf in attempts:
            valid = ok & (pt_idx >= 0)
            r = pnp_ransac(K, m.pt_xyz[pt_idx.clamp(min=0).long()], feats.xy,
                           torch.ones(n, device=self.device), valid,
                           picks=self._draw_picks(128, 4, valid), min_inliers=15,
                           run=self.graphs.run)
            if not bool(r.success):
                continue
            obs = torch.where(valid & r.inliers, pt_idx, -1)
            R, t, obs, n_inl = self._optimize_pose(feats, obs, r.R, r.t)
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
        m = steps.map_fields(self.map, steps.RELOC_SEARCH_FIELDS)
        for window, max_desc in ((10.0, 100), (3.0, 64)):
            obs, n_add = self.graphs.run(
                "reloc_search", steps.reloc_search_by_projection,
                dict(cam=cfg.cam, scale_factor=cfg.orb.scale_factor, n_levels=cfg.orb.n_levels,
                     window=window, max_desc_dist=max_desc),
                m=m, kf=self._index(kf), R=R, t=t, cur=feats, obs_pt=obs)
            if n_good + int(n_add) < 50:
                break
            R, t, obs, n_inl = self._optimize_pose(feats, obs, R, t)
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
        succeeds. TrackLocalMap runs only outside mbVO. The motion model at
        th=7 and th=14, the reference keyframe, the TrackLocalMap polish and
        the next VO points are segments through the tracker's graphs; the
        reads are the eager form's (the counts after each window, the
        reference keyframe's, the polish's inliers)."""
        cfg = self.cfg
        m = self.map
        last = self._last_feats

        def run_motion_model():
            vel_R, vel_t = self._velocity
            for th in (7.0, 14.0):
                R, t, ct, cx, n_map, n_tot, n_m = self.graphs.run(
                    "vo_mm", steps.vo_motion_segment,
                    dict(cam=cfg.cam, th=th, scale_factor=cfg.orb.scale_factor,
                         n_levels=cfg.orb.n_levels),
                    m=steps.map_fields(m, steps.MM_MAP_FIELDS), last_feats=last,
                    last_obs=self._last_obs, vo_xyz=self._vo_xyz, vo_valid=self._vo_valid,
                    last_R=self._last_R, last_t=self._last_t, vel_R=vel_R, vel_t=vel_t, feats=feats,
                    inv_sigma2_table=self.inv_sigma2)
                n_m, n_tot, n_map = self._fetch(n_m, n_tot, n_map)
                # >= 20 matches before the optimization, > 20 map + VO inliers.
                if n_m >= 20 and n_tot > 20:
                    self._kind = "mm"
                    return R, t, ct, cx, int(n_map)
            return None

        mm = None
        used_reloc = False
        if not self._vo_mode:
            mm = run_motion_model() if self._velocity is not None else None
            if mm is None and self._last_kf_idx >= 0:
                R, t, obs, n_matches, n_inl, _ = self.graphs.run(
                    "ref", steps.ref_segment, dict(cam=cfg.cam),
                    m=steps.map_fields(m, steps.REF_MAP_FIELDS), ref_kf=self._index(self._last_kf_idx),
                    feats=feats, last_R=self._last_R, last_t=self._last_t,
                    inv_sigma2_table=self.inv_sigma2)
                n_matches, n_inl = self._fetch(n_matches, n_inl)
                if n_matches >= 15 and n_inl >= 10:
                    ct = torch.where(obs >= 0, obs, -2)
                    cx = torch.where((obs >= 0)[:, None], m.pt_xyz[obs.clamp(min=0).long()], 0.0)
                    mm = (R, t, ct, cx, int(n_inl))
                    self._kind = "ref"
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
            self._kind = "reloc"
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
        self._vo_xyz, self._vo_valid = self.graphs.run(
            "vo_points", steps.vo_points_segment, dict(cam=cfg.cam, th_depth=float(self._th_depth)),
            feats=feats, cur_tag=cur_tag, cur_xyz=cur_xyz, R=R, t=t)
        return True

    # ------------------------------------------------- stereo / RGB-D input

    @property
    def _th_depth(self) -> float:
        """The close/far depth threshold: th_depth_factor baselines."""
        return self.cfg.th_depth_factor * self.cfg.cam.baseline

    def _frame_features_stereo(self, img_left: torch.Tensor, img_right: torch.Tensor) -> FrameFeatures:
        c = self.cfg.cam
        return self.graphs.run("front", steps.stereo_frame_features,
                               dict(config=self.cfg.orb, fx=c.fx, bf=c.bf), imgL=img_left, imgR=img_right)

    def _frame_features_rgbd(self, img: torch.Tensor, depth_map: torch.Tensor) -> FrameFeatures:
        """steps.rgbd_frame_features at the tracker's camera, ORB settings
        and depth_map_factor."""
        cfg = self.cfg
        return self.graphs.run("front", steps.rgbd_frame_features,
                               dict(cam=cfg.cam, orb=cfg.orb, depth_map_factor=cfg.depth_map_factor),
                               img=img, depth_map=depth_map)

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
        lo, hi = steps.point_ranges(self.scale_factors, torch.linalg.norm(X, dim=-1), feats.level)
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

    def reset(self):
        """Clear the map and restart at NO_IMAGES_YET (System::Reset): the
        mapping job joined, a running global BA superseded, the mapping
        process's loop-closing state cleared."""
        self._join_mapping()
        self._gba_generation += 1
        self._gba_future = None
        self.gba_graphs = StepGraphs(self.device, self.metrics, stage="gba.capture")
        self.map = self._empty_map()
        self.state = TrackingState.NO_IMAGES_YET
        self.trajectory = []
        self.n_recycled_kf_slots = 0
        if self.loop_closer is not None:  # the vocabulary is kept
            self.loop_closer = self._new_loop_closer(self.loop_closer.voc)
        self._reset_tracking()
        if self._remote_mapper is not None:
            self._remote_mapper.reset()

    # ------------------------------------------------------------- public API

    def _pose_out(self):
        """The current T_cw on the host, from the packed fetch when fresh."""
        if self._last_pose_np is not None:
            return tuple(np.asarray(x) for x in self._last_pose_np)
        return self._pose_np(self._last_R, self._last_t)

    def track_monocular(self, img: torch.Tensor, frame_id: int):
        """One (H, W) float32 grayscale frame on the tracker's device;
        returns T_cw (R, t) as numpy, or None."""
        with self._frame(frame_id):
            self.n_frames += 1
            if self.state in (TrackingState.NO_IMAGES_YET, TrackingState.NOT_INITIALIZED):
                self.state = TrackingState.NOT_INITIALIZED
                self._kind = "init"
                if self._try_initialize(self._frame_features(img, init=True), frame_id):
                    return self._pose_out()
                return None
            self._last_pose_np = None
            if self.state == TrackingState.OK:
                return self._after_ok_track(self._track_frame(None, frame_id, img=img), frame_id)
            return self._lost_track(self._frame_features(img), frame_id)

    def track_monocular_features(self, feats: FrameFeatures, frame_id: int):
        """track_monocular over precomputed FrameFeatures, once initialized."""
        with self._frame(frame_id):
            self.n_frames += 1
            self._last_pose_np = None
            if self.state == TrackingState.OK:
                return self._after_ok_track(self._track_frame(feats, frame_id), frame_id)
            return self._lost_track(feats, frame_id)

    def _after_ok_track(self, ok: bool, frame_id: int):
        if ok:
            return self._pose_out()
        self._kind = "lost"
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
        self._kind = "reloc" if ok else "lost"
        if ok:
            self.state = TrackingState.OK
            self._record_pose(frame_id, self._last_R, self._last_t)
            return self._pose_out()
        self._record_pose(frame_id, self._last_R, self._last_t, lost=True)
        return None

    def track_stereo(self, img_left: torch.Tensor, img_right: torch.Tensor, frame_id: int):
        """One rectified pair of (H, W) float32 images on the tracker's
        device; returns T_cw (R, t) as numpy, or None."""
        with self._frame(frame_id):
            with self._stage("track.stereo_features"):
                feats = self._frame_features_stereo(img_left, img_right)
            return self._track_with_depth(feats, frame_id)

    def track_rgbd(self, img: torch.Tensor, depth_map: torch.Tensor, frame_id: int):
        """One (H, W) float32 image and its registered (H, W) float32 depth
        image (raw units, times depth_map_factor gives metres) on the
        tracker's device; returns T_cw (R, t) as numpy, or None."""
        with self._frame(frame_id):
            with self._stage("track.rgbd_features"):
                feats = self._frame_features_rgbd(img, depth_map)
            return self._track_with_depth(feats, frame_id)

    def track_depth_features(self, feats: FrameFeatures, frame_id: int):
        """Stereo / RGB-D tracking over precomputed FrameFeatures with
        u_right and depth filled (the multi-stream front end's entry)."""
        with self._frame(frame_id):
            return self._track_with_depth(feats, frame_id)

    def _track_with_depth(self, feats: FrameFeatures, frame_id: int):
        self.n_frames += 1
        self._last_pose_np = None
        if self.state in (TrackingState.NO_IMAGES_YET, TrackingState.NOT_INITIALIZED):
            self.state = TrackingState.NOT_INITIALIZED
            self._kind = "init"
            if self._initialize_with_depth(feats, frame_id):
                return self._pose_out()
            return None
        if self.state == TrackingState.OK:
            return self._after_ok_track(self._track_frame(feats, frame_id), frame_id)
        return self._lost_track(feats, frame_id)

    def _drain(self):
        """Adopt the mapping job in flight, then merge a running global BA
        once it has finished."""
        self._join_mapping()
        if self._gba_future is not None:
            self._gba_future.result()
            self.map = self._poll_gba(self.map)

    def shutdown(self):
        """Finish the background work, close the mapping process and stop
        the threads (System::Shutdown waits for LocalMapping, LoopClosing
        and global BA); exporting stays valid, and mapping runs
        synchronously from here on."""
        self._drain()
        if self._remote_mapper is not None:
            self._remote_mapper.close()
            self._remote_mapper = None
        for pool in (self._mapping_pool, self._gba_pool):
            if pool is not None:
                pool.shutdown(wait=True)
        self._mapping_pool = self._gba_pool = None

    def export_trajectory(self):
        """The camera trajectory, the background work drained first: each
        frame's stored relative pose composed with its reference keyframe's
        optimized pose, a culled keyframe resolved through its spanning-tree
        parents. Returns a list of (frame_id, R_cw (3, 3), t_cw (3,), lost)
        as numpy."""
        self._drain()
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
