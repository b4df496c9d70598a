"""The public System facade: construct with camera settings and a sensor
type (monocular, stereo or RGB-D), feed frames, save trajectories, save and
load the map, render it, and publish it to a live viewer. Port of
tpuslam/pipeline/system.py."""

from __future__ import annotations

import enum
from typing import Optional

import numpy as np
import torch

from tpuslam_torch.geometry.camera import PinholeCamera
from tpuslam_torch.geometry.se3 import rotmat_to_quat
from tpuslam_torch.io import checkpoint
from tpuslam_torch.ops.orb import ORBConfig
from tpuslam_torch.pipeline.tracker import Tracker, TrackerConfig, TrackingState
from tpuslam_torch.viz.render import render_map_topdown
from tpuslam_torch.viz.server import LiveViewer


class SensorType(enum.Enum):
    MONOCULAR = 0
    STEREO = 1
    RGBD = 2


def _quat(Rwc: np.ndarray) -> np.ndarray:
    """[x, y, z, w] of a rotation, in float32 as the JAX package takes it."""
    return rotmat_to_quat(torch.from_numpy(np.asarray(Rwc, np.float32))).numpy()


class System:
    """System::TrackMonocular / TrackStereo / TrackRGBD / SaveTrajectoryTUM
    / SaveTrajectoryKITTI. The tracker runs on `device` ("cuda" unless the
    caller asks for the CPU)."""

    def __init__(self, cam: PinholeCamera, sensor: SensorType = SensorType.MONOCULAR,
                 orb: Optional[ORBConfig] = None, device="cuda", **tracker_kwargs):
        self.sensor = sensor
        self.tracker = Tracker(TrackerConfig(cam=cam, orb=orb or ORBConfig(), **tracker_kwargs),
                               device=device)
        self._timestamps = {}
        self._viewer = None
        self._viewer_every = 1

    def attach_viewer(self, viewer=None, every: int = 1, port: int = 8642):
        """Attach a live web viewer (viz.server.LiveViewer) that refreshes
        after every `every`-th tracked frame, the counterpart of the
        reference's bUseViewer flag. Returns the viewer (viewer.port says
        where it listens)."""
        if viewer is None:
            viewer = LiveViewer(port=port)
        self._viewer = viewer
        self._viewer_every = max(1, every)
        return viewer

    def _push_viewer(self):
        """Publish the map, the last 500 frames' camera centres and the
        current pose: one device->host read here (the keyframe poses, the
        current pose and the point count), one in LiveViewer.update."""
        tr = self.tracker
        if self._viewer is None or tr.n_frames % self._viewer_every:
            return
        m = tr.map
        K = m.kf_R.shape[0]
        packed = torch.cat([m.kf_R.reshape(-1), m.kf_t.reshape(-1), tr._last_R.reshape(-1),
                            tr._last_t.reshape(-1), m.pt_valid.sum().to(torch.float32).reshape(1)])
        kf_R, kf_t, R, t, n_pt = np.split(packed.cpu().numpy(), np.cumsum([9 * K, 3 * K, 9, 3]))
        kf_R, kf_t = kf_R.reshape(K, 3, 3), kf_t.reshape(K, 3)
        traj = []
        for _, ref, Rr, t_rel, lost in tr.trajectory[-500:]:
            if lost:
                continue
            if ref >= 0:
                Rr, t_rel = Rr @ kf_R[ref], Rr @ kf_t[ref] + t_rel
            traj.append(-Rr.T @ t_rel)
        self._viewer.update(m, trajectory=traj, cam_R=R.reshape(3, 3), cam_t=t,
                            status=f"{tr.state.name}  KFs={tr._n_kf_host} "
                            f"pts={int(n_pt[0])} frame={tr.n_frames}")

    def track_monocular(self, img, timestamp: float):
        """One grayscale frame (an (H, W) array or tensor); returns T_cw (R,
        t) as numpy, or None."""
        out = self.tracker.track_monocular(self._input(img), self._frame_id(timestamp))
        self._push_viewer()
        return out

    def track_stereo(self, img_left, img_right, timestamp: float):
        """One rectified grayscale pair; returns T_cw (R, t) as numpy, or
        None."""
        frame_id = self._frame_id(timestamp)
        out = self.tracker.track_stereo(self._input(img_left), self._input(img_right), frame_id)
        self._push_viewer()
        return out

    def track_rgbd(self, img, depth, timestamp: float):
        """One grayscale image and its registered depth image (raw units:
        depth_map_factor converts to metres); returns T_cw (R, t) as numpy,
        or None."""
        frame_id = self._frame_id(timestamp)
        out = self.tracker.track_rgbd(self._input(img), self._input(depth), frame_id)
        self._push_viewer()
        return out

    def _frame_id(self, timestamp: float) -> int:
        frame_id = self.tracker.n_frames
        self._timestamps[frame_id] = timestamp
        return frame_id

    def _input(self, a) -> torch.Tensor:
        """An array or tensor as float32 on the tracker's device."""
        return torch.as_tensor(a, dtype=torch.float32).to(self.tracker.device)

    @property
    def state(self) -> TrackingState:
        return self.tracker.state

    def map_stats(self):
        m = self.tracker.map
        return {"n_keyframes": int(m.n_kf), "n_points": int(m.pt_valid.sum()),
                "state": self.tracker.state.name}

    def reset(self):
        """Clear the map and restart tracking (System::Reset)."""
        self.tracker.reset()
        self._timestamps = {}

    def shutdown(self):
        """Finish the background mapping and global BA, close the mapping
        process and the viewer (System::Shutdown); the trajectory exports
        stay valid."""
        self.tracker.shutdown()
        if self._viewer is not None:
            self._viewer.close()
            self._viewer = None

    def activate_localization_mode(self):
        """Track against the frozen map, no new keyframes."""
        self.tracker.localization_mode = True

    def deactivate_localization_mode(self):
        self.tracker.localization_mode = False

    def save_map(self, path: str):
        """Checkpoint the map (io/checkpoint.py; the reference has none)."""
        checkpoint.save_map(self.tracker.map, path)

    def load_map(self, path: str, localization: bool = True):
        """Resume from a checkpoint on the tracker's device: the map and its
        host mirror of the keyframe watermark are replaced, localization
        mode is set (by default) and the state is LOST, so the next frame
        relocalizes against the loaded map.

        As in the JAX package, only the map is replaced. The loop closer is
        left as it is: in a fresh System it has no vocabulary and no
        database yet, so the relocalization finds no BoW candidate and
        matches the frame against every map point (the brute-force branch,
        `tracker.reloc_path`). The loaded keyframes are not enrolled in a
        database. The file's capacities must be the tracker's."""
        tr = self.tracker
        tr._drain()  # a mapping job in flight must not land on the loaded map
        m = checkpoint.load_map(path, device=tr.device)
        want = (tr.cfg.max_keyframes, tr.kp_capacity, tr.cfg.max_points)
        got = (m.capacity_kf, m.kf_obs_pt.shape[1], m.capacity_pt)
        if got != want:
            raise ValueError(f"checkpoint capacities (keyframes, keypoints, points) {got} are not "
                             f"the tracker's {want}")
        tr.map = m
        tr._n_kf_host = int(m.n_kf)
        tr.localization_mode = localization
        tr.state = TrackingState.LOST

    def render_map(self, path: str):
        """Write a top-down PNG of the map and the tracked trajectory
        (viz.render.render_map_topdown; needs PIL)."""
        traj = [(fid, R, t) for fid, R, t, lost in self.tracker.export_trajectory() if not lost]
        render_map_topdown(self.tracker.map, traj).save(path)

    def _write_tum(self, path: str, rows):
        with open(path, "w") as f:
            for ts, R, t in rows:
                Rwc = R.T
                twc = -Rwc @ t
                q = _quat(Rwc)
                f.write(f"{ts:.6f} {twc[0]:.7f} {twc[1]:.7f} {twc[2]:.7f} "
                        f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}\n")

    def save_trajectory_tum(self, path: str):
        """TUM format: timestamp tx ty tz qx qy qz qw of T_wc, tracked frames."""
        self._write_tum(path, [(self._timestamps.get(fid, float(fid)), R, t)
                               for fid, R, t, lost in self.tracker.export_trajectory() if not lost])

    def save_keyframe_trajectory_tum(self, path: str):
        """TUM format over the surviving keyframes in creation order
        (System::SaveKeyFrameTrajectoryTUM), the mapping job in flight
        adopted and a finished global BA merged first."""
        self.tracker._drain()
        m = self.tracker.map
        valid = m.kf_valid.cpu().numpy()
        fid = m.kf_frame_id.cpu().numpy()
        kf_R, kf_t = m.kf_R.cpu().numpy(), m.kf_t.cpu().numpy()
        order = np.nonzero(valid)[0]
        order = order[np.argsort(fid[order])]
        self._write_tum(path, [(self._timestamps.get(int(fid[k]), float(fid[k])), kf_R[k], kf_t[k])
                               for k in order])

    def save_trajectory_kitti(self, path: str):
        """KITTI format: the 12 entries of the 3x4 T_wc per frame."""
        with open(path, "w") as f:
            for _, R, t, _ in self.tracker.export_trajectory():
                Rwc = R.T
                M = np.concatenate([Rwc, (-Rwc @ t)[:, None]], axis=1)
                f.write(" ".join(f"{v:.9e}" for v in M.reshape(-1)) + "\n")
