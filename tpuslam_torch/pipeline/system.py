"""The public System facade: construct with camera settings and a sensor
type (monocular, stereo or RGB-D), feed frames, save trajectories. Port of
tpuslam/pipeline/system.py (the viewer, checkpoint and render hooks are not
ported yet)."""

from __future__ import annotations

import enum
from typing import Optional

import numpy as np
import torch

from tpuslam_torch.geometry.camera import PinholeCamera
from tpuslam_torch.geometry.se3 import rotmat_to_quat
from tpuslam_torch.ops.orb import ORBConfig
from tpuslam_torch.pipeline.tracker import Tracker, TrackerConfig, TrackingState


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

    def track_monocular(self, img, timestamp: float):
        """One grayscale frame (an (H, W) array or tensor); returns T_cw (R,
        t) as numpy, or None."""
        return self.tracker.track_monocular(self._input(img), self._frame_id(timestamp))

    def track_stereo(self, img_left, img_right, timestamp: float):
        """One rectified grayscale pair; returns T_cw (R, t) as numpy, or
        None."""
        frame_id = self._frame_id(timestamp)
        return self.tracker.track_stereo(self._input(img_left), self._input(img_right), frame_id)

    def track_rgbd(self, img, depth, timestamp: float):
        """One grayscale image and its registered depth image (raw units:
        depth_map_factor converts to metres); returns T_cw (R, t) as numpy,
        or None."""
        frame_id = self._frame_id(timestamp)
        return self.tracker.track_rgbd(self._input(img), self._input(depth), frame_id)

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
        self.tracker.shutdown()

    def activate_localization_mode(self):
        """Track against the frozen map, no new keyframes."""
        self.tracker.localization_mode = True

    def deactivate_localization_mode(self):
        self.tracker.localization_mode = False

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
        (System::SaveKeyFrameTrajectoryTUM)."""
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
