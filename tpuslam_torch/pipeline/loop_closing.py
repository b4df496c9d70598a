"""Loop closing: BoW detection, consistency chains, Sim3, loop correction.
Port of tpuslam/pipeline/loop_closing.py, the reference's LoopClosing
thread run synchronously on each new keyframe:

- DetectLoop: the BoW query gated by the lowest score among the covisible
  keyframes, candidates chained over 3 consecutive keyframes by the
  overlap of their covisibility groups;
- ComputeSim3: descriptor matching under a shared vocabulary node and the
  rotation-consistency filter, the Sim3 RANSAC, widening by mutual
  Sim3-guided projection, Gauss-Newton refinement and the final gate on
  the loop neighbourhood's re-found points;
- CorrectLoop: the correction propagated to the current keyframe's
  covisible group, loop fusion, the essential graph (spanning chain,
  strong covisibility, new loop connections and every earlier loop edge),
  point correction through the reference keyframes, then global BA.

The vocabulary is the shipped default (tpuslam/data/default_vocab.npz, read
by path), a TPUSLAM_VOCAB override first, a tree trained from the map's own
descriptors last. RANSAC hypotheses come from a torch.Generator (seed 42,
as the JAX package's PRNGKey(42)) through `_draw_picks`.

Host reads: a keyframe without a candidate makes two device->host reads
(the slot reconciliation and the candidates with their covisibility
rows); the minimum score over the covisible keyframes stays on the
device, so the count does not grow with the number of neighbours.
"""

from __future__ import annotations

import contextlib
import copy
import os
import warnings
from typing import Optional

import numpy as np
import torch

from tpuslam_torch.geometry.camera import project
from tpuslam_torch.geometry.se3 import se3_apply, se3_compose, se3_inverse, so3_project
from tpuslam_torch.geometry.sim3 import sim3_apply, sim3_compose, sim3_inverse
from tpuslam_torch.mapstate.core import MapState, compute_point_descriptors, covisibility_weights
from tpuslam_torch.matching.search import (
    TH_HIGH,
    TH_LOW,
    match_nn_ratio,
    rotation_consistency_mask,
    search_by_projection_points,
)
from tpuslam_torch.optim.pose_graph import Sim3Edges, make_relative, optimize_pose_graph
from tpuslam_torch.pipeline._index import scatter_last_dropping, sf_pow
from tpuslam_torch.pipeline.graphs import StepGraphs
from tpuslam_torch.place.database import SparseBow, SparseKeyFrameDatabase, l1_score_sparse
from tpuslam_torch.place.vocabulary import (
    DEFAULT_VOCAB_1M_PATH,
    DEFAULT_VOCAB_PATH,
    Vocabulary,
    sparse_bow_vector,
    train_vocabulary,
    transform_words,
)
from tpuslam_torch.sfm.initializer import draw_picks
from tpuslam_torch.sfm.sim3solver import optimize_sim3, sim3_chi2_inliers, sim3_ransac
from tpuslam_torch.utils.metrics import Metrics

COVIS_CONSISTENCY_TH = 3   # LoopClosing.cc:43
MIN_KF_GAP = 10            # at least 10 keyframes since the last loop
STRONG_COVIS = 100         # essential-graph covisibility threshold
DENSE_NODES = 192          # live keyframes up to which the graph is solved densely


def _host(*xs) -> list:
    """Device tensors on the host in one device->host read (flattened into
    one float64 buffer, then cut back into numpy arrays of their shapes)."""
    flat = torch.cat([x.reshape(-1).to(torch.float64) for x in xs]).cpu().numpy()
    out, o = [], 0
    for x in xs:
        n = x.numel()
        out.append(flat[o:o + n].reshape(tuple(x.shape)))
        o += n
    return out


def _to_device(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host array on `dev` without a synchronising copy (pinned memory,
    non-blocking)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.pin_memory().to(dev, non_blocking=True) if dev.type == "cuda" else t


class LoopCloser:
    def __init__(self, max_keyframes: int, fix_scale: bool, voc: Optional[Vocabulary] = None,
                 voc_k: int = 8, voc_levels: int = 3, min_sim3_inliers: int = 20,
                 min_total_matches: int = 40):
        self.voc = voc
        self.voc_k = voc_k
        self.voc_levels = voc_levels
        self.db: Optional[SparseKeyFrameDatabase] = None
        self.max_keyframes = max_keyframes
        self.fix_scale = fix_scale
        self.min_sim3_inliers = min_sim3_inliers
        self.min_total_matches = min_total_matches
        self._tried_default = False
        self._bow = {}
        self._kp_nodes_cache = {}
        self._consistent_groups = []  # [(set of slots, count)]
        self.generator = torch.Generator().manual_seed(42)
        self.n_loops_closed = 0
        # Slots are not temporal order once the tracker recycles them: an
        # insertion sequence number per slot gates by time, and the per-slot
        # caches are reconciled against kf_frame_id on every call.
        self._seq = 0
        self._last_loop_seq = -(10 ** 9)
        self._slot_seq = np.full(max_keyframes, -1, np.int64)
        self._slot_fid = np.full(max_keyframes, -1, np.int64)
        # Loop edges by frame-id pairs, kept for every later essential graph.
        self._loop_edges: list = []
        # The latest closure's point-slot forwarding (MapPoint::Replace),
        # (P,) int32 on the map's device, for the tracker's live references.
        self.last_point_remap: Optional[torch.Tensor] = None
        self.metrics = Metrics()
        self.stage_sync = False
        self.pose_graph_stats: dict = {}
        # The essential graph's runner (optimize_pose_graph's `run`): None
        # runs each solve's GN segments and CG blocks through `graphs`, the
        # closer's own StepGraphs (CUDA graphs on a card, kept from one
        # closure to the next, so a later closure in the same edge bucket
        # replays them); pipeline/graphs.py's call_segment runs them
        # eagerly.
        self.cg_run = None
        self.graphs: Optional[StepGraphs] = None

    def __getstate__(self):
        """Copies and pickles leave the captured graphs behind."""
        return dict(self.__dict__, graphs=None)

    def to(self, device) -> "LoopCloser":
        """A copy of the closer's whole state (vocabulary, database, caches,
        chains, loop edges, generator) on `device`, to rerun a keyframe
        there from the same state."""
        dev = torch.device(device)
        lc = copy.copy(self)
        if self.voc is not None:
            lc.voc = self.voc.to(dev)
        if self.db is not None:
            lc.db = copy.copy(self.db)
            lc.db.words, lc.db.weight, lc.db.has = (x.to(dev, copy=True) for x in
                                                    (self.db.words, self.db.weight, self.db.has))
        lc._bow = {k: SparseBow(b.words.to(dev), b.weight.to(dev)) for k, b in self._bow.items()}
        lc._kp_nodes_cache = {k: v.to(dev) for k, v in self._kp_nodes_cache.items()}
        lc._consistent_groups = [(set(g), c) for g, c in self._consistent_groups]
        lc._slot_seq, lc._slot_fid = self._slot_seq.copy(), self._slot_fid.copy()
        lc._loop_edges = list(self._loop_edges)
        lc.generator = torch.Generator()
        lc.generator.set_state(self.generator.get_state())
        lc.metrics, lc.pose_graph_stats, lc.last_point_remap = Metrics(), {}, None
        return lc

    def _run(self, dev: torch.device):
        """The essential graph's `run`: cg_run when set, else the closer's
        StepGraphs (made at the first solve, on the map's device)."""
        if self.cg_run is not None:
            return self.cg_run
        if self.graphs is None:
            self.graphs = StepGraphs(dev, self.metrics, stage="loop.capture")
        return self.graphs.run

    @contextlib.contextmanager
    def _stage(self, name: str, dev: torch.device):
        with self.metrics.stage(name):
            yield
            if self.stage_sync and dev.type == "cuda":
                torch.cuda.current_stream(dev).synchronize()  # this thread's stream only

    def _draw_picks(self, n_hyp: int, size: int, valid: torch.Tensor) -> torch.Tensor:
        """The Sim3 RANSAC's index sets (128 x 3), from the closer's generator."""
        return draw_picks(n_hyp, size, valid, self.generator)

    def _ensure_vocabulary(self, m: MapState) -> bool:
        if self.voc is not None:
            return True
        dev = m.kf_R.device
        if not self._tried_default:
            self._tried_default = True
            for path in (os.environ.get("TPUSLAM_VOCAB"), DEFAULT_VOCAB_PATH, DEFAULT_VOCAB_1M_PATH):
                if path and os.path.exists(path):
                    self.voc = Vocabulary.load(path, device=dev)
                    return True
        # Else train once the map holds >= 3 keyframes and 500 descriptors.
        n_kf = int(m.n_kf)
        if n_kf < 3:
            return False
        corpus = m.kf_kp_desc[:n_kf][m.kf_kp_valid[:n_kf]].cpu().numpy().view(np.uint32)
        if len(corpus) < 500:
            return False
        warnings.warn(
            "tpuslam_torch: shipped default vocabulary not found; training a tiny "
            f"in-session fallback ({self.voc_k}^{self.voc_levels} words from the first "
            "keyframes). Loop and relocalization recall will be degraded.", stacklevel=2)
        self.voc = train_vocabulary(corpus[:6000], k=self.voc_k, levels=self.voc_levels, seed=7,
                                    device=dev)
        return True

    def _reconcile(self, m: MapState):
        """Drop the per-slot state of slots whose occupant changed (culled, or
        recycled for a new keyframe): one read of the slots' frame ids."""
        fid, valid = _host(m.kf_frame_id, m.kf_valid)
        fid = fid.astype(np.int64)
        fid[valid < 0.5] = -1
        for s in np.nonzero(fid != self._slot_fid)[0]:
            s = int(s)
            self._bow.pop(s, None)
            self._kp_nodes_cache.pop(s, None)
            if self.db is not None:
                self.db.erase(s)
            self._slot_seq[s] = -1
        self._slot_fid = fid

    def _kf_bow(self, m: MapState, k: int) -> SparseBow:
        if k not in self._bow:
            self._bow[k] = sparse_bow_vector(self.voc, m.kf_kp_desc[k], m.kf_kp_valid[k])
        return self._bow[k]

    def _kp_nodes(self, m: MapState, k: int) -> torch.Tensor:
        """Per-keypoint vocabulary node ids at DBoW2's levelsup=4 level
        (floored to >= ~100 nodes): the FeatureVector that SearchByBoW
        matches under. -1 = invalid."""
        if k not in self._kp_nodes_cache:
            voc = self.voc
            lvl = voc.levels - 4
            while lvl < voc.levels - 1 and voc.k ** lvl < 100:
                lvl += 1
            lvl = max(1, min(lvl, voc.levels - 1))
            words = transform_words(voc, m.kf_kp_desc[k], m.kf_kp_valid[k])
            div = voc.k ** (voc.levels - lvl)
            self._kp_nodes_cache[k] = torch.where(words >= 0, torch.div(words, div, rounding_mode="floor"), -1)
        return self._kp_nodes_cache[k]

    # -------------------------------------------------------------- detection

    def _detect(self, m: MapState, kf: int, covis: torch.Tensor) -> Optional[int]:
        """A loop-candidate slot, or None."""
        dev = m.kf_R.device
        K = self.max_keyframes
        if self.db is None:
            self.db = SparseKeyFrameDatabase(self.voc.n_words, K, m.kf_kp_desc.shape[1], device=dev)
        v = self._kf_bow(m, kf)
        self._seq += 1
        self._slot_seq[kf] = self._seq
        if self._seq - self._last_loop_seq < MIN_KF_GAP or self._seq <= MIN_KF_GAP:
            self.db.add(kf, v)
            self._consistent_groups = []
            return None

        neighbors = covis[kf] >= 15
        # minScore: the lowest BoW similarity among the covisible keyframes
        # the database holds, all of them in one reduction on the device.
        v_dense = v.densify(self.voc.n_words)
        nb_scores = l1_score_sparse(SparseBow(self.db.words, self.db.weight), v_dense)
        min_score = torch.clamp(torch.where(neighbors & self.db.has, nb_scores, 1.0).min(), max=1.0)

        recent = (self._slot_seq >= 0) & (self._slot_seq > self._seq - MIN_KF_GAP)
        exclude = neighbors | _to_device(recent, dev)
        exclude[kf].fill_(True)
        idx, ok = self.db.query(v, exclude, covis, min_score=min_score, max_candidates=6)
        self.db.add(kf, v)
        # The candidates and their covisibility rows in one read.
        idx_h, ok_h, rows = _host(idx, ok, covis[idx] >= 15)
        cands = [(int(i), r) for i, o, r in zip(idx_h, ok_h, rows) if o > 0.5]
        if not cands:
            self._consistent_groups = []
            return None

        # Covisibility-consistency chaining.
        new_groups = []
        enough = None
        for c, row in cands:
            group = {c} | set(np.nonzero(row > 0.5)[0].tolist())
            count = 0
            for prev_group, prev_count in self._consistent_groups:
                if group & prev_group:
                    count = max(count, prev_count + 1)
            new_groups.append((group, count))
            if count >= COVIS_CONSISTENCY_TH - 1 and enough is None:
                enough = c
        self._consistent_groups = new_groups
        return enough

    # ------------------------------------------------------------------ sim3

    def _kf_cam_points(self, m: MapState, kf: int):
        """Camera-frame positions of the keyframe's map points per keypoint
        slot, and the slots that hold one: (X (N, 3), has (N,))."""
        obs = m.kf_obs_pt[kf]
        o = obs.clamp(min=0).long()
        has = (obs >= 0) & m.kf_kp_valid[kf] & m.pt_valid[o]
        return se3_apply(m.kf_R[kf], m.kf_t[kf], m.pt_xyz[o]), has

    def _search_by_sim3(self, m: MapState, cam, kf_cur: int, kf_loop: int, s21, R21, t21):
        """ORBmatcher::SearchBySim3: mutually consistent Sim3-guided
        projection matching of the two keyframes' map points. Returns (idx_f
        (N,), mutual (N,)) per loop-keyframe slot."""
        N = m.kf_obs_pt.shape[1]
        X_c, has_c = self._kf_cam_points(m, kf_cur)
        X_l, has_l = self._kf_cam_points(m, kf_loop)

        def search(X, has, src, dst):
            lvl = m.kf_kp_level[src]
            return search_by_projection_points(
                project(cam, X), m.kf_kp_desc[src], has & (X[:, 2] > 0), 7.5 * sf_pow(1.2, lvl),
                torch.clamp(lvl - 1, min=0), lvl + 1, m.kf_kp_xy[dst], m.kf_kp_desc[dst],
                m.kf_kp_level[dst], m.kf_kp_angle[dst], m.kf_kp_valid[dst], max_dist=TH_HIGH)

        idx_f, _, ok_f = search(sim3_apply(s21, R21, t21, X_l), has_l, kf_loop, kf_cur)
        idx_b, _, ok_b = search(sim3_apply(*sim3_inverse(s21, R21, t21), X_c), has_c, kf_cur, kf_loop)
        mutual = ok_f & ok_b[idx_f] & (idx_b[idx_f] == torch.arange(N, device=idx_f.device))
        return idx_f, mutual

    def _loop_point_mask(self, m: MapState, kf_loop: int, covis: torch.Tensor) -> torch.Tensor:
        """mvpLoopMapPoints: every valid point observed by the loop keyframe
        or its covisible neighbourhood, as a (P,) mask (no host read)."""
        P = m.capacity_pt
        K = m.capacity_kf
        rows = covis[kf_loop] >= 15
        rows[kf_loop].fill_(True)
        rows &= torch.arange(K, device=rows.device) < m.n_kf
        hasv = (m.kf_obs_pt >= 0) & m.kf_kp_valid & rows[:, None]
        flat = torch.where(hasv, m.kf_obs_pt, P).reshape(-1).long()
        mark = torch.zeros((P + 1,), dtype=torch.bool, device=flat.device).index_fill(0, flat, True)
        return mark[:P] & m.pt_valid

    def _project_match_points(self, m: MapState, cam, kf: int, s_cw, R_cw, t_cw, pt_mask,
                              radius_mult: float, max_dist: int):
        """Project the masked map points through a Sim3 camera pose S_cw and
        match them against keyframe kf's keypoints (SearchByProjection and
        Fuse with Scw). Returns (idx (P,), ok (P,)). Only the masked points
        in the image are searched (one read: their count); the others come
        back not ok."""
        P = m.capacity_pt
        dev = m.pt_xyz.device
        Xc = sim3_apply(s_cw, R_cw, t_cw, m.pt_xyz)
        uv = project(cam, Xc)
        center = sim3_inverse(s_cw, R_cw, t_cw)[2]
        dist = torch.linalg.norm(m.pt_xyz - center[None], dim=-1)
        finite = torch.isfinite(m.pt_max_dist) & (m.pt_max_dist > 0)
        ratio = torch.where(finite, m.pt_max_dist / torch.clamp(dist, min=1e-9), 1.0)
        log_sf = torch.log(torch.full((), 1.2, dtype=torch.float32, device=dev))
        pred = torch.clamp(torch.ceil(torch.log(torch.clamp(ratio, min=1e-9)) / log_sf), 0, 7).to(torch.int32)
        in_img = ((Xc[:, 2] > 0) & (uv[:, 0] >= 0) & (uv[:, 0] < cam.width)
                  & (uv[:, 1] >= 0) & (uv[:, 1] < cam.height))
        lo = torch.where(finite, torch.clamp(pred - 1, min=0), 0)
        hi = torch.where(finite, pred + 1, 7)
        sel = torch.nonzero(pt_mask & in_img)[:, 0]
        idx = torch.zeros((P,), dtype=torch.int64, device=dev)
        ok = torch.zeros((P,), dtype=torch.bool, device=dev)
        if sel.numel() == 0:
            return idx, ok
        idx_s, _, ok_s = search_by_projection_points(
            uv[sel], m.pt_desc[sel], torch.ones(sel.shape, dtype=torch.bool, device=dev),
            radius_mult * sf_pow(1.2, pred[sel]), lo[sel], hi[sel], m.kf_kp_xy[kf], m.kf_kp_desc[kf],
            m.kf_kp_level[kf], m.kf_kp_angle[kf], m.kf_kp_valid[kf], max_dist=max_dist)
        return idx.index_put((sel,), idx_s), ok.index_put((sel,), ok_s)

    def _neighborhood_matches(self, m: MapState, cam, kf_cur: int, kf_loop: int, s21, R21, t21,
                              covis: torch.Tensor):
        """The loop neighbourhood's points projected into the current frame
        through the corrected S_cw = S21 T_loop,w and matched (th = 10).
        Returns (hit (N,), match_pt (N,) the matched point or -1, nb_mask
        (P,))."""
        nb_mask = self._loop_point_mask(m, kf_loop, covis)
        one = torch.ones((), device=s21.device)
        s_cw, R_cw, t_cw = sim3_compose(s21, R21, t21, one, m.kf_R[kf_loop], m.kf_t[kf_loop])
        idx, ok = self._project_match_points(m, cam, kf_cur, s_cw, R_cw, t_cw, nb_mask, 10.0, TH_LOW)
        N = m.kf_obs_pt.shape[1]
        P = m.capacity_pt
        tgt = torch.where(ok, idx, N)
        # ok matches are one-to-one: no two writes meet in a live slot.
        hit = torch.zeros((N,), dtype=torch.bool, device=ok.device)
        hit = scatter_last_dropping(hit, tgt, ok)
        pts = torch.where(ok, torch.arange(P, dtype=torch.int32, device=ok.device), -1)
        match_pt = scatter_last_dropping(torch.full((N,), -1, dtype=torch.int32, device=ok.device), tgt, pts)
        return hit, match_pt, nb_mask

    def _compute_sim3(self, m: MapState, cam, kf_cur: int, kf_loop: int, covis: torch.Tensor):
        """LoopClosing::ComputeSim3. Returns (s, R, t, match_pt, nb_mask),
        (s, R, t) mapping loop-keyframe camera coordinates to the current
        keyframe's, or None if rejected."""
        N = m.kf_obs_pt.shape[1]
        dev = m.kf_R.device
        obs_c, obs_l = m.kf_obs_pt[kf_cur], m.kf_obs_pt[kf_loop]
        has_c = (obs_c >= 0) & m.kf_kp_valid[kf_cur] & m.pt_valid[obs_c.clamp(min=0).long()]
        has_l = (obs_l >= 0) & m.kf_kp_valid[kf_loop] & m.pt_valid[obs_l.clamp(min=0).long()]
        # FeatureVector constraint: only descriptors under the same node match.
        nc, nl = self._kp_nodes(m, kf_cur), self._kp_nodes(m, kf_loop)
        pair = has_c[:, None] & has_l[None, :] & (nc[:, None] == nl[None, :]) & (nc >= 0)[:, None]
        idx, _, ok = match_nn_ratio(m.kf_kp_desc[kf_cur], m.kf_kp_desc[kf_loop], pair,
                                    max_dist=50, nn_ratio=0.75)
        ok = rotation_consistency_mask(m.kf_kp_angle[kf_loop][idx], m.kf_kp_angle[kf_cur], ok)
        if int(ok.sum()) < self.min_sim3_inliers:
            return None

        def match_arrays(idx):
            X2 = se3_apply(m.kf_R[kf_cur], m.kf_t[kf_cur], m.pt_xyz[obs_c.clamp(min=0).long()])
            X1 = se3_apply(m.kf_R[kf_loop], m.kf_t[kf_loop], m.pt_xyz[obs_l[idx].clamp(min=0).long()])
            sigma2_2 = sf_pow(1.2, 2.0 * m.kf_kp_level[kf_cur].to(torch.float32))
            sigma2_1 = sf_pow(1.2, 2.0 * m.kf_kp_level[kf_loop][idx].to(torch.float32))
            return X1, X2, m.kf_kp_xy[kf_loop][idx], m.kf_kp_xy[kf_cur], sigma2_1, sigma2_2

        X1, X2, uv1, uv2, sigma2_1, sigma2_2 = match_arrays(idx)
        res = sim3_ransac(cam.K, X1, X2, uv1, uv2, 9.21 * sigma2_1, 9.21 * sigma2_2, ok,
                          picks=self._draw_picks(128, 3, ok), fix_scale=self.fix_scale,
                          min_inliers=self.min_sim3_inliers)
        if not bool(res.success):
            return None

        # Widen with mutual guided projection (SearchBySim3), then refine.
        idx_f, mutual = self._search_by_sim3(m, cam, kf_cur, kf_loop, res.s, res.R, res.t)
        tgt = torch.where(mutual, idx_f, N)  # mutual matches are injective
        add = scatter_last_dropping(torch.full((N,), -1, dtype=torch.int64, device=dev), tgt,
                                    torch.arange(N, device=dev))
        merged_idx = torch.where(ok, idx, torch.clamp(add, min=0))
        merged_ok = ok | ((add >= 0) & has_c)
        X1, X2, uv1, uv2, sigma2_1, sigma2_2 = match_arrays(merged_idx)
        merged_ok = sim3_chi2_inliers(cam.K, res.s, res.R, res.t, X1, X2, uv1, uv2,
                                      9.21 * sigma2_1, 9.21 * sigma2_2, merged_ok)
        s, R, t, inl, n_inl = optimize_sim3(cam.K, res.s, res.R, res.t, X1, X2, uv1, uv2,
                                            1.0 / sigma2_1, 1.0 / sigma2_2, merged_ok,
                                            fix_scale=self.fix_scale)
        if int(n_inl) < self.min_sim3_inliers:
            return None

        # >= 40 matches with the loop neighbourhood's projected points.
        nb_hit, match_pt, nb_mask = self._neighborhood_matches(m, cam, kf_cur, kf_loop, s, R, t, covis)
        sim3_ok = merged_ok & inl
        if int((nb_hit | sim3_ok).sum()) < self.min_total_matches:
            return None
        # mvpCurrentMatchedPoints: the Sim3 inliers take precedence.
        sim3_pt = torch.where(sim3_ok, obs_l[merged_idx], -1)
        return s, R, t, torch.where(sim3_pt >= 0, sim3_pt, match_pt), nb_mask

    # ------------------------------------------------------------ correction

    def _fuse_loop_points(self, m: MapState, cam, kf_cur: int, match_pt, nb_mask, group_poses):
        """Loop fusion and SearchAndFuse on the host, as the JAX package:
        each current keypoint with a matched loop point takes it (its own
        point replaced), then every corrected group keyframe fuses the loop
        points projected through its corrected Sim3 (th = 4). Returns the
        fused map and sets last_point_remap."""
        P = m.capacity_pt
        dev = m.kf_R.device
        obs = m.kf_obs_pt.cpu().numpy().copy()
        ptv = m.pt_valid.cpu().numpy().copy()
        repl = np.arange(P, dtype=np.int64)

        def replace(old: int, new: int):
            repl[old] = new
            ptv[old] = False

        # Every group keyframe's projection from the unchanged map, one read.
        projected = [(g, *self._project_match_points(m, cam, g, sg, Rg, tg, nb_mask, 4.0, TH_LOW))
                     for g, (sg, Rg, tg) in group_poses.items()]
        host = _host(match_pt, *(x for _, idx, ok in projected for x in (idx, ok)))
        mp = host[0].astype(np.int64)
        for i in np.nonzero(mp >= 0)[0]:
            q = int(mp[i])
            if not ptv[q]:
                continue
            cur = int(obs[kf_cur, i])
            if cur >= 0 and cur != q and ptv[cur]:
                replace(cur, q)
            else:
                obs[kf_cur, i] = q
        for n, (g, _, _) in enumerate(projected):
            idxn, okn = host[1 + 2 * n].astype(np.int64), host[2 + 2 * n] > 0.5
            for p in np.nonzero(okn)[0]:
                p = int(p)
                if not ptv[p]:
                    continue
                kp = int(idxn[p])
                q = int(obs[g, kp])
                if q >= 0 and q != p and ptv[q]:
                    replace(q, p)
                elif q < 0:
                    obs[g, kp] = p

        # Short replacement chains resolved, then every observation redirected.
        repl = repl[repl]
        repl = repl[repl]
        obs = np.where(obs >= 0, repl[np.maximum(obs, 0)], obs)
        self.last_point_remap = _to_device(repl.astype(np.int32), dev)
        m = m._replace(kf_obs_pt=_to_device(obs.astype(np.int32), dev), pt_valid=_to_device(ptv, dev))
        touched = nb_mask & m.pt_valid
        if bool(touched.any()):
            m = compute_point_descriptors(m, touched)
        return m

    def _correct(self, m: MapState, cam, kf_cur: int, kf_loop: int, s21, R21, t21,
                 covis: torch.Tensor, ba_fn=None, match_pt=None, nb_mask=None) -> MapState:
        """CorrectLoop: Sim3 propagation to the covisible group, loop fusion,
        new loop connections, the essential graph with every earlier loop
        edge, point correction, global BA (ba_fn)."""
        K = m.capacity_kf
        dev = m.kf_R.device
        one = torch.ones((), device=dev)
        s_corr, R_corr, t_corr = sim3_compose(torch.as_tensor(s21, device=dev), R21, t21, one,
                                              m.kf_R[kf_loop], m.kf_t[kf_loop])
        s_old, R_old, t_old = torch.ones((K,), device=dev), m.kf_R, m.kf_t

        # The current keyframe's covisible group: S_kw = (T_k T_cur^-1) S_cw.
        n_kf, row = _host(m.n_kf, covis[kf_cur] >= 15)
        group = sorted(g for g in set(np.nonzero(row > 0.5)[0].tolist()) | {kf_cur} if g < int(n_kf))
        G = _to_device(np.asarray(group, np.int64), dev)
        Rrel, trel = se3_compose(m.kf_R[G], m.kf_t[G], *se3_inverse(m.kf_R[kf_cur], m.kf_t[kf_cur]))
        sg, Rg, tg = sim3_compose(torch.ones((len(group),), device=dev), Rrel, trel, s_corr, R_corr, t_corr)
        s_init, R_init, t_init = s_old.clone(), R_old.clone(), t_old.clone()
        s_init[G], R_init[G], t_init[G] = sg, Rg, tg
        group_poses = {g: (sg[n], Rg[n], tg[n]) for n, g in enumerate(group)}

        if match_pt is not None and nb_mask is not None:
            with self._stage("loop.fuse", dev):
                m = self._fuse_loop_points(m, cam, kf_cur, match_pt, nb_mask, group_poses)

        with self._stage("loop.essential_graph", dev):
            covis_post = covisibility_weights(m)
            covis_post_np, covis_np, valid_np, fid_np = _host(covis_post, covis, m.kf_valid, m.kf_frame_id)
            valid_np = valid_np > 0.5
            fid_np = fid_np.astype(np.int64)
            group_arr = np.asarray(group, np.int64)
            in_group = np.zeros(K, bool)
            in_group[group_arr] = True
            # New loop connections: links the fusion made that did not exist
            # before, strong ones, and the (current, loop) pair.
            newly = ((covis_post_np[group_arr] >= 15) & (covis_np[group_arr] < 15)
                     & valid_np[None, :] & ~in_group[None, :])
            strong_new = covis_post_np[group_arr] >= STRONG_COVIS
            is_loop_pair = np.zeros_like(newly)
            is_loop_pair[group.index(kf_cur), kf_loop] = True
            gi, bi = np.nonzero(newly & (strong_new | is_loop_pair))
            loop_connections = [(int(group_arr[g]), int(b)) for g, b in zip(gi, bi)]

            # Edges from the pre-correction poses: the temporal chain over the
            # valid keyframes in frame-id order, strong covisibility at chain
            # distance >= 2, then the loop edge.
            order = sorted(np.nonzero(valid_np)[0].tolist(), key=lambda k: int(fid_np[k]))
            ov = np.asarray(order, np.int64)
            pa = np.arange(len(ov))
            strong = (pa[None, :] >= pa[:, None] + 2) & (covis_np[np.ix_(ov, ov)] >= STRONG_COVIS)
            sa, sb = np.nonzero(strong)
            old_a = np.concatenate([ov[:-1], ov[sa]]).astype(np.int64)
            old_b = np.concatenate([ov[1:], ov[sb]]).astype(np.int64)
            seen = {(min(int(a), int(b)), max(int(a), int(b))) for a, b in zip(old_a, old_b)}
            seen.add((min(kf_loop, kf_cur), max(kf_loop, kf_cur)))
            init_a, init_b = [], []
            for a, b in loop_connections:
                key = (min(a, b), max(a, b))
                if key not in seen:
                    seen.add(key)
                    init_a.append(a)
                    init_b.append(b)
            # Loop edges of earlier closures, measured from the current poses.
            fid_to_slot = {int(fid_np[k]): k for k in order}
            extra_a, extra_b = [], []
            for fa, fb in self._loop_edges:
                a, b = fid_to_slot.get(fa), fid_to_slot.get(fb)
                if a is None or b is None:
                    continue  # one side culled; its constraint is already in the poses
                key = (min(a, b), max(a, b))
                if key not in seen:
                    seen.add(key)
                    extra_a.append(a)
                    extra_b.append(b)
            old_a = np.concatenate([old_a, np.asarray(extra_a, np.int64)])
            old_b = np.concatenate([old_b, np.asarray(extra_b, np.int64)])

            ia, ib = _to_device(old_a, dev), _to_device(old_b, dev)
            msA, mRA, mtA = make_relative(s_old[ia], R_old[ia], t_old[ia], s_old[ib], R_old[ib], t_old[ib])
            ei = np.concatenate([old_a, [kf_loop], np.asarray(init_a, np.int64)])
            ej = np.concatenate([old_b, [kf_cur], np.asarray(init_b, np.int64)])
            ja = _to_device(np.asarray(init_a, np.int64), dev)
            jb = _to_device(np.asarray(init_b, np.int64), dev)
            msB, mRB, mtB = make_relative(s_init[ja], R_init[ja], t_init[ja], s_init[jb], R_init[jb], t_init[jb])
            self._last_edge_slots = [(int(a), int(b)) for a, b in zip(ei, ej)]
            E = len(ei)
            edges = Sim3Edges(
                i=_to_device(ei.astype(np.int32), dev), j=_to_device(ej.astype(np.int32), dev),
                meas_s=torch.cat([msA, torch.as_tensor(s21, device=dev).reshape(1), msB]),
                meas_R=torch.cat([mRA, R21[None], mRB]), meas_t=torch.cat([mtA, t21[None], mtB]),
                valid=torch.ones((E,), dtype=torch.bool, device=dev), weight=torch.ones((E,), device=dev))

            # Dense or CG by the live node count: a small session's live
            # keyframes are compacted into a fixed 192-node dense problem.
            self.pose_graph_stats = stats = {}
            run = self._run(dev)
            g = self.graphs if self.cg_run is None else None
            g0 = (g.captures, g.replays, len(g.captured)) if g is not None else None
            n_live = len(order)
            if n_live <= DENSE_NODES < K:
                comp = np.full(K, DENSE_NODES - 1, np.int64)
                comp[ov] = np.arange(n_live)
                sel = _to_device(np.asarray(order + [order[-1]] * (DENSE_NODES - n_live), np.int64), dev)
                comp_t = _to_device(comp, dev)
                edges_c = edges._replace(i=comp_t[edges.i.long()], j=comp_t[edges.j.long()])
                nfixed = torch.zeros((DENSE_NODES,), dtype=torch.bool, device=dev)
                nfixed[int(comp[kf_loop])].fill_(True)
                s_c, R_c, t_c, _ = optimize_pose_graph(
                    s_init[sel], R_init[sel], t_init[sel], torch.arange(DENSE_NODES, device=dev) < n_live,
                    nfixed, edges_c, iters=15, fix_scale=self.fix_scale, dense_max_nodes=DENSE_NODES,
                    stats=stats, run=run)
                live = _to_device(ov, dev)
                s_new, R_new, t_new = s_init.clone(), R_init.clone(), t_init.clone()
                s_new[live], R_new[live], t_new[live] = s_c[:n_live], R_c[:n_live], t_c[:n_live]
            else:
                node_fixed = torch.zeros((K,), dtype=torch.bool, device=dev)
                node_fixed[kf_loop].fill_(True)
                s_new, R_new, t_new, _ = optimize_pose_graph(
                    s_init, R_init, t_init, m.kf_valid, node_fixed, edges, iters=15,
                    fix_scale=self.fix_scale, dense_max_nodes=DENSE_NODES, stats=stats,
                    run=run)
            stats.update(n_live=n_live, n_edges=E)
            if g is not None:
                stats["graph"] = dict(captures=g.captures - g0[0], replays=g.replays - g0[1],
                                      captured=g.captured[g0[2]:], pool_bytes=g.pool_bytes())

            # Point correction through each point's reference keyframe, then
            # the SE3 poses back (t / s) with exact rotations.
            ref = torch.clamp(m.pt_ref_kf, 0, K - 1).long()
            Xc = sim3_apply(s_old[ref], R_old[ref], t_old[ref], m.pt_xyz)
            X_corr = sim3_apply(*sim3_inverse(s_new[ref], R_new[ref], t_new[ref]), Xc)
            pt_xyz = torch.where(m.pt_valid[:, None], X_corr, m.pt_xyz)
            t_se3 = t_new / torch.clamp(s_new, min=1e-9)[:, None]
            m = m._replace(kf_R=so3_project(R_new), kf_t=t_se3, pt_xyz=pt_xyz)

        if ba_fn is not None:
            with self._stage("loop.global_ba", dev):
                m = ba_fn(m)
        pair = (int(fid_np[kf_loop]), int(fid_np[kf_cur]))
        if pair not in self._loop_edges:
            self._loop_edges.append(pair)
        self._last_loop_seq = self._seq
        self.n_loops_closed += 1
        return m

    # --------------------------------------------------------------- public

    def on_keyframe(self, m: MapState, cam, kf_cur: int, ba_fn=None):
        """Detection and closure for a newly inserted keyframe: the map's
        covisibility weights are computed once and serve detection and the
        Sim3 stage. Returns (map, closed)."""
        self.last_point_remap = None
        if not self._ensure_vocabulary(m):
            return m, False
        dev = m.kf_R.device
        with self._stage("loop.detect", dev):
            self._reconcile(m)
            covis = covisibility_weights(m)
            cand = self._detect(m, kf_cur, covis)
        if cand is None:
            return m, False
        with self._stage("loop.sim3", dev):
            sim3 = self._compute_sim3(m, cam, kf_cur, cand, covis)
        if sim3 is None:
            return m, False
        s21, R21, t21, match_pt, nb_mask = sim3
        # Odometric-consistency gate (the JAX package's deviation from the
        # reference): the correction the Sim3 implies against the current
        # odometry must stay within a drift budget of the path between them.
        Rrel, trel = se3_compose(m.kf_R[kf_cur], m.kf_t[kf_cur], *se3_inverse(m.kf_R[cand], m.kf_t[cand]))
        t21_h, trel_h, R21_h, Rrel_h = _host(t21, trel, R21, Rrel)
        f32 = np.float32
        d_t = float(np.linalg.norm(t21_h.astype(f32) - trel_h.astype(f32)))
        dR = R21_h.astype(f32) @ Rrel_h.astype(f32).T
        d_ang = np.rad2deg(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))
        path = self._path_length_between(m, cand, kf_cur)
        frac = 0.05 if self.fix_scale else 0.15
        if d_t > max(0.3, frac * path) or d_ang > max(5.0, 0.5 * path):
            self.metrics.inc("loop.gate_rejected")
            return m, False
        m = self._correct(m, cam, kf_cur, cand, s21, R21, t21, covis, ba_fn=ba_fn,
                          match_pt=match_pt, nb_mask=nb_mask)
        return m, True

    @staticmethod
    def _path_length_between(m: MapState, a: int, b: int) -> float:
        """Camera-centre polyline length over the valid keyframes in frame-id
        order between keyframes a and b."""
        fid, valid, R, t = _host(m.kf_frame_id, m.kf_valid, m.kf_R, m.kf_t)
        fid = fid.astype(np.int64)
        lo, hi = sorted((int(fid[a]), int(fid[b])))
        sel = np.nonzero((valid > 0.5) & (fid >= lo) & (fid <= hi))[0]
        if len(sel) < 2:
            return 0.0
        order = sel[np.argsort(fid[sel], kind="stable")]
        Ro = R[order].astype(np.float32)
        to = t[order].astype(np.float32)
        C = -np.einsum("kij,ki->kj", Ro.transpose(0, 2, 1), to)
        return float(np.sum(np.linalg.norm(np.diff(C, axis=0), axis=1)))
