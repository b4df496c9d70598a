"""Synthetic scenes without jax: a numpy copy of tests/synthetic.py's
make_texture, StepWallScene and orbit_trajectory (blur and rotations from
this package), the inputs of a coherent tracking step, a tracking session
over a real MapState (build_depth_session), rendered monocular, stereo and
RGB-D frames (render_frames, render_stereo_frames, render_rgbd_frames), a
System session over them (mono_session, depth_session) and its ATE after a
Sim3 or a rigid alignment (trajectory_ate), and a drifted loop map for loop
closing (build_loop_map).

A coherent step: the keypoints of a frame rendered at pose A, back-projected
through A's depth image, are both the last frame's points and the first
points of the local map; the step then tracks a frame rendered at pose B
from A as the prediction. Random images and descriptors (what
entry_batched's example uses) match nothing, so they leave pose
optimization with no inliers to test.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpuslam_torch.geometry.camera import PinholeCamera, project, unproject
from tpuslam_torch.geometry.se3 import se3_apply, se3_inverse, so3_exp
from tpuslam_torch.mapstate.core import (
    FrameFeatures,
    MapState,
    compute_point_descriptors,
    insert_keyframe,
    insert_points,
    make_empty_map,
    update_point_normals,
)
from tpuslam_torch.ops.image import gaussian_blur
from tpuslam_torch.ops.orb import ORBConfig, extract_orb, extract_orb_batched
from tpuslam_torch.pipeline.steps import FUSED_ACCEPT, fused_track_frame_image
from tpuslam_torch.pipeline.tracker import pad_feats


def make_texture(rng, h=600, w=800):
    tex = rng.uniform(0, 255, (h, w)).astype(np.float32)
    tex = gaussian_blur(torch.from_numpy(tex), 7, 2.0).numpy()
    for _ in range(400):
        y, x = rng.integers(5, h - 15), rng.integers(5, w - 15)
        s = int(rng.integers(3, 11))
        tex[y : y + s, x : x + s] = rng.uniform(0, 255)
    return tex


class StepWallScene:
    """Staircase of fronto-parallel textured slabs: world-x bands at varied
    depths (the same scene as tests/synthetic.py)."""

    def __init__(self, rng, depths=(3.5, 5.0, 4.2, 6.5, 3.8, 5.8, 4.6, 7.0),
                 band=1.2, tex_scale=60.0, ssaa=3):
        self.textures = [make_texture(rng, 500, 500) for _ in depths]
        self.depths = depths
        self.band = band
        self.tex_scale = tex_scale
        self.ssaa = ssaa
        self._tex_cache = {}

    def render(self, cam: PinholeCamera, R, t, with_depth: bool = False, device=None):
        """Render from world->camera pose (R, t) with `ssaa`x supersampling;
        with_depth=True also returns the point-sampled camera-frame depth.
        Numpy arrays, as tests/synthetic.py gives them (the image float64,
        the depth float32); with a `device`, tensors there, computed there."""
        dev = torch.device("cpu" if device is None else device)
        s = self.ssaa
        if s > 1:
            cam_hi = PinholeCamera(
                fx=cam.fx * s, fy=cam.fy * s,
                cx=cam.cx * s + (s - 1) / 2.0, cy=cam.cy * s + (s - 1) / 2.0,
                width=cam.width * s, height=cam.height * s,
            )
            out = self._render_once(cam_hi, R, t, dev)[0]
            out = out.reshape(cam.height, s, cam.width, s).mean(dim=(1, 3))
            z = self._render_once(cam, R, t, dev)[1] if with_depth else None
        else:
            out, z = self._render_once(cam, R, t, dev)
        if device is None:
            out = out.numpy()
            z = None if z is None else z.numpy()
        return (out, z) if with_depth else out

    def _texture(self, i: int, dev: torch.device) -> torch.Tensor:
        key = (i, str(dev))
        if key not in self._tex_cache:
            self._tex_cache[key] = torch.from_numpy(self.textures[i]).to(dev)
        return self._tex_cache[key]

    def _render_once(self, cam: PinholeCamera, R, t, dev: torch.device):
        """(image (H, W) float64, depth (H, W) float32) by ray casting. The
        arithmetic is tests/synthetic.py's numpy arithmetic, dtypes included:
        the bilinear weights come out float64 there (float32 - int64)."""
        H, W = cam.height, cam.width
        f32 = torch.float32
        R = torch.as_tensor(np.asarray(R, np.float32), device=dev)
        t = torch.as_tensor(np.asarray(t, np.float32), device=dev)
        vv, uu = torch.meshgrid(torch.arange(H, dtype=f32, device=dev),
                                torch.arange(W, dtype=f32, device=dev), indexing="ij")
        C = -R.T @ t
        d = R.T @ torch.stack(
            [(uu - cam.cx) / cam.fx, (vv - cam.cy) / cam.fy, torch.ones_like(uu)], 0
        ).reshape(3, -1)
        nb = len(self.depths)
        x_lo = -0.5 * nb * self.band
        out = torch.zeros(H * W, dtype=torch.float64, device=dev)
        zbuf = torch.zeros(H * W, dtype=f32, device=dev)
        best_lam = torch.full((H * W,), float("inf"), dtype=f32, device=dev)
        d2 = torch.where(torch.abs(d[2]) < 1e-9, torch.full_like(d[2], 1e-9), d[2])
        for i, z_plane in enumerate(self.depths):
            lam = (z_plane - C[2]) / d2
            P = C[:, None] + lam * d
            band_idx = torch.floor((P[0] - x_lo) / self.band)
            in_band = torch.clamp(band_idx, 0, nb - 1) == i
            hit = (lam > 0) & in_band & (lam < best_lam)
            tex = self._texture(i, dev)
            th, tw = tex.shape
            tx = torch.clamp(P[0] * self.tex_scale + tw / 2, 0, tw - 2)
            ty = torch.clamp(P[1] * self.tex_scale + th / 2, 0, th - 2)
            x0 = tx.long()
            y0 = ty.long()
            wx = tx.double() - x0
            wy = ty.double() - y0
            val = (
                tex[y0, x0] * (1 - wx) * (1 - wy)
                + tex[y0, x0 + 1] * wx * (1 - wy)
                + tex[y0 + 1, x0] * (1 - wx) * wy
                + tex[y0 + 1, x0 + 1] * wx * wy
            )
            out = torch.where(hit, val, out)
            z_cam = (R[2] @ P) + t[2]
            zbuf = torch.where(hit, z_cam, zbuf)
            best_lam = torch.where(hit, lam, best_lam)
        return out.reshape(H, W), zbuf.reshape(H, W)


def orbit_trajectory(n_frames, step=0.04, yaw_rate=0.004, x0=0.0):
    """World->camera poses for a gentle lateral translation with slow yaw,
    the camera centre starting at world x = x0."""
    poses = []
    for i in range(n_frames):
        w = torch.tensor([0.0, yaw_rate * i, 0.0], dtype=torch.float32)
        R = so3_exp(w).numpy()
        C = np.array([x0 + step * i, 0.01 * np.sin(i * 0.3), 0.002 * i], np.float32)
        poses.append((R, (-R @ C).astype(np.float32)))
    return poses


def coherent_track_inputs(scene: StepWallScene, cam: PinholeCamera, cfg: ORBConfig,
                          pose_pairs, n_local: int, rng, device="cpu"):
    """Inputs of track_step_batched for B = len(pose_pairs) streams, stream b
    tracking from pose_pairs[b][0] (frame A, also the prediction R0, t0) to
    pose_pairs[b][1] (frame B, the ground truth).

    The last frame's points are A's keypoints back-projected through A's
    depth (invalid keypoints go behind the camera); the local map is those
    points followed by n_local - N random points with random descriptors.
    Returns a dict of numpy arrays named as track_step_batched's arguments
    (descriptors uint32, the JAX package's words) plus R_gt, t_gt.
    """
    imgs_a, depths, imgs_b = [], [], []
    for (Ra, ta), (Rb, tb) in pose_pairs:
        img, z = scene.render(cam, Ra, ta, with_depth=True)
        imgs_a.append(img)
        depths.append(z)
        imgs_b.append(scene.render(cam, Rb, tb))
    feats = extract_orb_batched(torch.from_numpy(np.stack(imgs_a)).to(device), cfg)
    xy = feats.xy.cpu().numpy()
    level = feats.level.cpu().numpy()
    kp_ok = feats.valid.cpu().numpy()
    desc = feats.desc.cpu().numpy().view(np.uint32)
    B, N = level.shape
    sf = cfg.scale_factor
    out = {k: [] for k in ("last_xyz", "map_xyz", "map_desc", "map_normal",
                           "map_min_d", "map_max_d")}
    for b, ((Ra, ta), _) in enumerate(pose_pairs):
        Ra, ta = np.asarray(Ra, np.float32), np.asarray(ta, np.float32)
        u = np.clip(np.round(xy[b, :, 0]).astype(int), 0, cam.width - 1)
        v = np.clip(np.round(xy[b, :, 1]).astype(int), 0, cam.height - 1)
        z = depths[b][v, u]
        ok = kp_ok[b] & (z > 0)
        z = np.where(ok, z, -10.0)  # unusable points: behind the camera
        p_cam = np.stack([(xy[b, :, 0] - cam.cx) / cam.fx * z,
                          (xy[b, :, 1] - cam.cy) / cam.fy * z, z], -1)
        p_cam[~ok, :2] = 0.0
        pw = ((p_cam - ta) @ Ra).astype(np.float32)  # R^T (p - t), row-wise
        Ca = -Ra.T @ ta
        # MapPoint::UpdateNormalAndDepth: distance range from the octave.
        d0 = np.linalg.norm(pw - Ca, axis=-1)
        max_d = d0 * sf ** level[b]
        min_d = max_d / sf ** (cfg.n_levels - 1)
        # Random extra map points in front of camera A.
        n_rand = n_local - N
        rc = np.stack([rng.uniform(-3, 3, n_rand), rng.uniform(-2, 2, n_rand),
                       rng.uniform(4, 10, n_rand)], -1)
        rw = ((rc - ta) @ Ra).astype(np.float32)
        rd = np.linalg.norm(rw - Ca, axis=-1)
        mw = np.concatenate([pw, rw])
        md = np.concatenate([d0, rd])
        out["last_xyz"].append(pw)
        out["map_xyz"].append(mw)
        out["map_desc"].append(np.concatenate(
            [desc[b], rng.integers(0, 2**32, (n_rand, 8), dtype=np.uint32)]))
        out["map_normal"].append((mw - Ca) / np.maximum(md, 1e-9)[:, None])
        out["map_min_d"].append(np.concatenate([min_d, 0.2 * rd]))
        out["map_max_d"].append(np.concatenate([max_d, 1.5 * rd]))
    res = {k: np.stack(v).astype(np.uint32 if k == "map_desc" else np.float32)
           for k, v in out.items()}
    res.update(
        imgs=np.stack(imgs_b).astype(np.float32),
        last_desc=desc,
        last_level=level.astype(np.int32),
        last_angle=feats.angle.cpu().numpy(),
        R0=np.stack([np.asarray(a[0], np.float32) for a, _ in pose_pairs]),
        t0=np.stack([np.asarray(a[1], np.float32) for a, _ in pose_pairs]),
        R_gt=np.stack([np.asarray(b[0], np.float32) for _, b in pose_pairs]),
        t_gt=np.stack([np.asarray(b[1], np.float32) for _, b in pose_pairs]),
    )
    return res


TRACK_STEP_ARGS = ("imgs", "last_xyz", "last_desc", "last_level", "last_angle",
                   "map_xyz", "map_desc", "map_normal", "map_min_d", "map_max_d",
                   "R0", "t0")


def pose_errors(R, t, R_gt, t_gt):
    """Per-stream (translation error |t - t_gt|, rotation error in degrees)."""
    R, t = np.asarray(R, np.float64), np.asarray(t, np.float64)
    dR = np.einsum("bij,bkj->bik", R, np.asarray(R_gt, np.float64))
    cos = np.clip((np.trace(dR, axis1=1, axis2=2) - 1.0) / 2.0, -1.0, 1.0)
    return np.linalg.norm(t - t_gt, axis=-1), np.degrees(np.arccos(cos))


def scale_tables(cfg: ORBConfig, device="cpu"):
    """(scale_factors, inv_sigma2) per octave, float32, as the tracker
    builds them."""
    sf = cfg.scale_factor
    n = cfg.n_levels
    return (torch.tensor([sf**l for l in range(n)], dtype=torch.float32, device=device),
            torch.tensor([1.0 / (sf**l) ** 2 for l in range(n)], dtype=torch.float32,
                         device=device))


def orb_frame_features(f, depth=None) -> FrameFeatures:
    """A monocular frame's FrameFeatures from ORBFeatures (no stereo; depth
    0 = unknown unless given), as fused_track_frame_image builds them."""
    n = f.xy.shape[0]
    dev = f.xy.device
    return FrameFeatures(
        xy=f.xy, level=f.level, angle=f.angle, desc=f.desc, valid=f.valid,
        u_right=torch.full((n,), -1.0, device=dev),
        depth=torch.zeros((n,), device=dev) if depth is None else depth,
    )


def depth_at(depth_img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """The rendered depth at each keypoint's nearest pixel (0 = none)."""
    H, W = depth_img.shape
    u = torch.clamp(torch.round(xy[:, 0]).long(), 0, W - 1)
    v = torch.clamp(torch.round(xy[:, 1]).long(), 0, H - 1)
    return depth_img[v, u]


def add_depth_keyframe(m: MapState, cam: PinholeCamera, feats_p: FrameFeatures, obs_p,
                       R, t, frame_id: int, ki: int, scale_factors):
    """Insert keyframe slot `ki` (the next free one) at pose (R, t) with
    observations obs_p, add a map point for every untracked keypoint with
    depth (Tracker._add_depth_points, without its depth threshold), then
    refresh the normals and the new points' descriptors. Returns
    (map, the keyframe's observations)."""
    m, _ = insert_keyframe(m, feats_p, R, t, frame_id, obs_p)
    P = m.capacity_pt
    d = feats_p.depth
    free = (obs_p < 0) & feats_p.valid & (d > 0)
    Xc = unproject(cam, feats_p.xy, d)
    Xw = se3_apply(*se3_inverse(R, t), Xc)
    dist = torch.linalg.norm(Xc, dim=-1)
    max_d = dist * scale_factors[torch.clamp(feats_p.level, 0, scale_factors.shape[0] - 1).long()]
    min_d = max_d / scale_factors[-1]
    vecs = Xw - (-(R.T @ t))
    normal = vecs / torch.clamp(torch.linalg.norm(vecs, dim=-1, keepdim=True), min=1e-9)
    m, slots = insert_points(m, Xw, feats_p.desc, ki, free, normal, 0.8 * min_d, 1.2 * max_d)
    created = free & (slots >= 0)
    obs = torch.where(created, slots, obs_p)
    kf_obs = m.kf_obs_pt.clone()
    kf_obs[ki] = obs
    m = update_point_normals(m._replace(kf_obs_pt=kf_obs), scale_factors)
    new = torch.zeros(P + 1, dtype=torch.bool, device=obs.device).index_fill(
        0, torch.where(created, slots, P).long(), True)[:P]
    return compute_point_descriptors(m, new), obs


class TrackState(NamedTuple):
    """What the tracker carries from one frame to the next: the inputs of
    fused_track_frame_image besides the image and the settings."""

    m: MapState
    last_feats: FrameFeatures
    last_obs: torch.Tensor
    last_R: torch.Tensor
    last_t: torch.Tensor
    vel_R: torch.Tensor
    vel_t: torch.Tensor
    has_vel: bool
    ref_kf: int


class DepthSession(NamedTuple):
    state: TrackState          # after the last frame
    frames: list               # one dict per tracked frame
    snapshots: dict            # frame index -> (TrackState before it, image)
    n_kf: int
    scale_factors: torch.Tensor
    inv_sigma2: torch.Tensor


def build_depth_session(scene: StepWallScene, cam: PinholeCamera, cfg: ORBConfig, poses,
                        K: int, N_cap: int, P: int, kf_every: int, device="cpu",
                        min_inliers_motion: int = 10, accept_thr: float = 30.0,
                        max_local_pts: int = 0, cand_cap: int = 0,
                        snapshot_at=(), on_frame=None) -> DepthSession:
    """A coherent map built by the port alone, frame by frame, along
    `poses` (world->camera, from orbit_trajectory):

    1. keyframe 0 at its ground-truth pose, its keypoints back-projected
       through the rendered depth into map points;
    2. every next frame tracked by fused_track_frame_image, carrying the
       last features, observations, pose and velocity as Tracker._track_frame
       does (on acceptance only);
    3. every `kf_every` accepted frames, a keyframe at the frame's
       ground-truth pose with the frame's observations, new points for its
       untracked keypoints with depth, normals and descriptors refreshed.
       The port has no bundle adjustment yet: the exact pose stands in for
       what mapping would give, so any pose error is the tracking step's
       own and does not drift over the session;
    4. after each keyframe the velocity is dropped, so the next frame takes
       the reference-keyframe branch.

    Keyframes come at a fixed cadence, not from NeedNewKeyFrame, so the
    session is deterministic. `snapshot_at` lists frames whose input state
    and image are kept; `on_frame(i, record)` runs after each tracked frame.
    """
    scale_factors, inv_sigma2 = scale_tables(cfg, device)
    m = make_empty_map(K, N_cap, P, device)

    def pose(i):
        return (torch.from_numpy(np.asarray(poses[i][0], np.float32)).to(device),
                torch.from_numpy(np.asarray(poses[i][1], np.float32)).to(device))

    def keyframe(m, feats, obs, depth_img, i, ki):
        feats_p = pad_feats(feats._replace(depth=depth_at(depth_img, feats.xy)), N_cap)
        obs_p = torch.cat([obs, torch.full((N_cap - obs.shape[0],), -1, dtype=obs.dtype,
                                           device=obs.device)])
        m, kf_obs = add_depth_keyframe(m, cam, feats_p, obs_p, *pose(i), i, ki, scale_factors)
        return m, kf_obs[: obs.shape[0]]

    def render(i):
        img, z = scene.render(cam, *poses[i], with_depth=True, device=device)
        return img.to(torch.float32), z

    img, z = render(0)
    feats = orb_frame_features(extract_orb(img, cfg))
    N = feats.xy.shape[0]
    m, obs = keyframe(m, feats, torch.full((N,), -1, dtype=torch.int32, device=device), z, 0, 0)
    eye, zero = torch.eye(3, device=device), torch.zeros(3, device=device)
    st = TrackState(m, feats, obs, *pose(0), eye, zero, False, 0)
    n_kf, since_kf = 1, 0
    frames, snapshots = [], {}
    for i in range(1, len(poses)):
        img_t, z = render(i)
        if i in snapshot_at:
            snapshots[i] = (st, img_t)
        feats, R, t, obs, vel_R, vel_t, pt_visible, pt_found, packed = fused_track_frame_image(
            cam, cfg, st.m, img_t, st.last_feats, st.last_obs, st.last_R, st.last_t,
            st.vel_R, st.vel_t, st.has_vel, st.ref_kf, inv_sigma2, accept_thr,
            min_inliers_motion=min_inliers_motion, max_local_pts=max_local_pts,
            cand_cap=cand_cap,
        )
        p = packed.cpu().numpy()  # the per-frame device->host fetch
        rec = dict(frame=i, packed=p, has_vel=st.has_vel, keyframe=False,
                   R=R.cpu().numpy(), t=t.cpu().numpy(), R_gt=poses[i][0], t_gt=poses[i][1])
        if p[FUSED_ACCEPT] > 0.5:
            st = TrackState(st.m._replace(pt_visible=pt_visible, pt_found=pt_found),
                            feats, obs, R, t, vel_R, vel_t, True, st.ref_kf)
            since_kf += 1
            if since_kf == kf_every and n_kf < K:
                m, obs = keyframe(st.m, feats, obs, z, i, n_kf)
                st = TrackState(m, feats, obs, *pose(i), eye, zero, False, n_kf)
                n_kf, since_kf = n_kf + 1, 0
                rec["keyframe"] = True
        frames.append(rec)
        if on_frame is not None:
            on_frame(i, rec)
    return DepthSession(st, frames, snapshots, n_kf, scale_factors, inv_sigma2)


def render_frames(scene: StepWallScene, cam: PinholeCamera, poses, device="cpu") -> list:
    """The (H, W) float32 images of `scene` at `poses` (world->camera), on
    `device`."""
    return [scene.render(cam, R, t, device=device).to(torch.float32) for R, t in poses]


def render_stereo_frames(scene: StepWallScene, cam: PinholeCamera, poses, device="cpu") -> list:
    """(left, right) (H, W) float32 image pairs of `scene` on `device`: the
    right camera is the left one moved by the baseline bf / fx along its
    own x axis (a rectified pair)."""
    shift = np.array([cam.baseline, 0.0, 0.0], np.float32)
    return [(scene.render(cam, R, t, device=device).to(torch.float32),
             scene.render(cam, R, np.asarray(t, np.float32) - shift, device=device).to(torch.float32))
            for R, t in poses]


def render_rgbd_frames(scene: StepWallScene, cam: PinholeCamera, poses, device="cpu",
                       depth_scale: float = 5000.0) -> list:
    """(image, depth) pairs of `scene`: the (H, W) float32 image on
    `device`, and the depth as a dataset stores it, an (H, W) uint16 numpy
    array of depth_scale units per metre (TUM's 5000; 0 = no depth)."""
    out = []
    for R, t in poses:
        img, z = scene.render(cam, R, t, with_depth=True, device=device)
        raw = torch.clamp(torch.round(z.to(torch.float64) * depth_scale), 0, 65535)
        out.append((img.to(torch.float32), raw.cpu().numpy().astype(np.uint16)))
    return out


def _timed_session(system, track, frames, on_frame) -> list:
    import time

    def sync():
        if system.tracker.device.type == "cuda":
            torch.cuda.synchronize(system.tracker.device)

    res = []
    for i, args in enumerate(frames):
        sync()
        t0 = time.perf_counter()
        out = track(*args, i / 30.0)
        sync()
        res.append((out, (time.perf_counter() - t0) * 1e3))
        if on_frame is not None:
            on_frame(i, out)
    return res


def mono_session(system, frames, on_frame=None) -> list:
    """Feed `system.track_monocular` the images `frames`, timestamps i / 30
    s. Returns one (T_cw or None, ms) per frame: the call's wall time, the
    card synchronized before and after it. on_frame(i, out) runs after each
    frame."""
    return _timed_session(system, system.track_monocular, [(f,) for f in frames], on_frame)


def depth_session(system, frames, on_frame=None) -> list:
    """mono_session for a stereo System (`frames` of (left, right) pairs,
    through track_stereo) or an RGB-D one ((image, depth) pairs, through
    track_rgbd)."""
    track = system.track_stereo if system.sensor.name == "STEREO" else system.track_rgbd
    return _timed_session(system, track, frames, on_frame)


def keep_mapping_inputs(tracker, jobs=None) -> dict:
    """Wrap tracker._mapping_compute so that the input (map, keyframe slot)
    of its calls is kept in the returned dict, keyed by the call's index
    from 0: every call's, or those in `jobs` (each map kept holds the card
    memory of a whole MapState)."""
    kept = {}
    compute = tracker._mapping_compute
    calls = [0]

    def wrapped(m, ki):
        if jobs is None or calls[0] in jobs:
            kept[calls[0]] = (m, ki)
        calls[0] += 1
        return compute(m, ki)

    tracker._mapping_compute = wrapped
    return kept


def trajectory_ate(trajectory, poses, fix_scale: bool = False):
    """The ATE of an exported trajectory ((frame_id, R, t, lost) tuples)
    against the ground-truth `poses`: camera centres of the tracked frames,
    Sim3-aligned (horn_sim3: the monocular scale is free), or rigidly (SE3,
    scale 1) with fix_scale for a depth sensor's metric trajectory. Returns
    (ATE RMSE, number of frames, (s, R, t) of the alignment)."""
    from tpuslam_torch.sfm.sim3solver import horn_sim3

    est, gt = [], []
    for frame_id, R, t, lost in trajectory:
        if lost:
            continue
        est.append(-R.T @ t)
        Rg, tg = poses[frame_id]
        gt.append(-np.asarray(Rg).T @ np.asarray(tg))
    est = np.asarray(est, np.float32)
    gt = np.asarray(gt, np.float32)
    s, R, t = horn_sim3(torch.from_numpy(est), torch.from_numpy(gt), torch.ones(len(est)),
                        fix_scale=fix_scale)
    aligned = float(s) * est @ R.numpy().T + t.numpy()
    ate = float(np.sqrt(np.mean(np.sum((aligned - gt) ** 2, axis=-1))))
    return ate, len(est), (float(s), R.numpy(), t.numpy())


# The camera of build_loop_map's keyframes (tests/test_loop_closing.py's).
LOOP_CAM = PinholeCamera(fx=400.0, fy=400.0, cx=160.0, cy=120.0, width=320, height=240)


def build_loop_map(rng, n_kf: int = 16, drift: float = 0.012, revisit: bool = True,
                   max_kf: int | None = None, n_kp: int = 200, max_pt: int | None = None,
                   device="cpu"):
    """A drifted loop map built directly on a MapState (a port of
    tests/test_loop_closing.py's build_loop_map, capacities as arguments):
    cameras on a circle of radius 6 facing outward at clusters of 40 points
    on a radius-10 wall, each keyframe observing its own cluster, the
    previous one and 20 points of the one before. Odometry drifts by `drift`
    rad of yaw and `drift` m along x per keyframe. With `revisit` the last 3
    keyframes also see clusters 0 and 1 through DUPLICATE points (the same
    descriptors, drift-displaced positions): the situation loop closing must
    recognize. Keypoints are LOOP_CAM's projections. Returns (map, gt
    poses, drifted poses), poses as (R, t) numpy float32 pairs."""
    R_circle = 6.0
    clusters, cluster_desc = [], []
    for k in range(n_kf):
        ang = 2 * np.pi * k / n_kf
        center = np.array([(R_circle + 4.0) * np.sin(ang), 0.0, -(R_circle + 4.0) * np.cos(ang)])
        clusters.append((center + rng.uniform(-1.5, 1.5, (40, 3))).astype(np.float32))
        cluster_desc.append(rng.integers(0, 2**32, (40, 8), dtype=np.uint32))

    def rot_y(a: float) -> np.ndarray:
        return so3_exp(torch.tensor([0.0, a, 0.0], dtype=torch.float32)).numpy()

    gt = []
    for k in range(n_kf):
        ang = 2 * np.pi * k / n_kf
        C = np.array([R_circle * np.sin(ang), 0.0, -R_circle * np.cos(ang)], np.float32)
        R = rot_y(np.pi - ang).T  # the camera's +z points outward through C
        gt.append((R.astype(np.float32), (-R @ C).astype(np.float32)))
    drifted = [gt[0]]
    dR = rot_y(drift)
    for k in range(1, n_kf):
        Rrel = gt[k][0] @ gt[k - 1][0].T
        trel = gt[k][1] - Rrel @ gt[k - 1][1]
        Rrel_n = dR @ Rrel
        trel_n = trel + np.array([drift, 0, 0], np.float32)
        drifted.append((Rrel_n @ drifted[k - 1][0], Rrel_n @ drifted[k - 1][1] + trel_n))

    N = n_kp
    m = make_empty_map(max_kf or max(24, n_kf + 8), N, max_pt or max(2400, n_kf * 44 + 400), device)
    N_WEAK = 20  # the weak covisibility tail (k - 2) keeps minScore realistic
    n_revisit = 3 if revisit else 0
    prev_own = prev2_own = dup_slots = None
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    for k in range(n_kf):
        R_d, t_d = drifted[k]
        j1, j2 = max(k - 1, 0), (k - 2 if k > 1 else 0)
        is_revisit = k >= n_kf - n_revisit
        extra = [0, 1] if is_revisit else []
        pts_gt = np.concatenate([clusters[k], clusters[j1], clusters[j2][:N_WEAK]]
                                + [clusters[c] for c in extra])
        descs = np.concatenate([cluster_desc[k], cluster_desc[j1], cluster_desc[j2][:N_WEAK]]
                               + [cluster_desc[c] for c in extra])
        n_obs = len(pts_gt)
        assert n_obs <= N
        # The gt view's camera-frame geometry, stored through the DRIFTED pose.
        R_gt, t_gt = gt[k]
        X_map = ((pts_gt @ R_gt.T + t_gt) - t_d) @ R_d
        desc_arr = np.zeros((N, 8), np.uint32)
        desc_arr[:n_obs] = descs
        valid = np.zeros(N, bool)
        valid[:n_obs] = True
        obs = np.full(N, -1, np.int32)
        new_mask = np.zeros(N, bool)
        new_mask[:40] = True
        creates_dups = is_revisit and dup_slots is None
        if creates_dups:
            new_mask[80:n_obs] = True
        xyz = np.zeros((N, 3), np.float32)
        xyz[:n_obs] = X_map
        m, slots = insert_points(m, t(xyz), t(desc_arr.view(np.int32)), k, t(new_mask),
                                 torch.zeros((N, 3), device=device), torch.zeros(N, device=device),
                                 torch.full((N,), float("inf"), device=device))
        slots = slots.cpu().numpy()
        obs[new_mask] = slots[new_mask]
        n_pw = 80 + N_WEAK
        if k > 0:
            obs[40:80] = prev_own
        if k > 1:
            obs[80:n_pw] = prev2_own[:N_WEAK]
        if is_revisit:
            if creates_dups:
                dup_slots = slots[n_pw:n_obs].copy()
            else:
                obs[n_pw:n_obs] = dup_slots
        else:
            prev2_own = prev_own.copy() if prev_own is not None else slots[:40].copy()
            prev_own = slots[:40].copy()

        # Observations: the stored positions through the drifted pose.
        Xs = m.pt_xyz[t(np.maximum(obs, 0)).long()]
        uv = project(LOOP_CAM, se3_apply(t(R_d), t(t_d), Xs))
        xy = torch.where(t(obs >= 0)[:, None], uv, 0.0)
        feats = FrameFeatures(xy=xy, level=torch.zeros(N, dtype=torch.int32, device=device),
                              angle=torch.zeros(N, device=device), desc=t(desc_arr.view(np.int32)),
                              valid=t(valid), u_right=torch.full((N,), -1.0, device=device),
                              depth=torch.zeros(N, device=device))
        m, _ = insert_keyframe(m, feats, t(R_d), t(t_d), k, t(obs))
    return m, gt, drifted
