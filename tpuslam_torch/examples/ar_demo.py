"""Monocular AR demo: live-feed tracking, plane detection and a cube
overlay (the reference's Examples/ROS/ORB_SLAM2/src/AR/ros_mono_ar.cc).
Port of examples/ar_demo.py.

Frames are pushed through the live-feed adapter (the ROS-subscriber
analog), a dominant plane is RANSAC-fitted to the well-observed map points
on the tracker's device, and a virtual cube resting on it is drawn into
each tracked frame (PIL).

Usage: python -m tpuslam_torch.examples.ar_demo [n_frames] [out_dir]
"""

from __future__ import annotations

import os
import sys
import tempfile
import time

import numpy as np
import torch

from tpuslam_torch.geometry.camera import PinholeCamera
from tpuslam_torch.io.live import LiveRunner
from tpuslam_torch.ops.orb import ORBConfig
from tpuslam_torch.pipeline.system import SensorType, System
from tpuslam_torch.testing import StepWallScene, orbit_trajectory
from tpuslam_torch.viz.ar import detect_plane, draw_ar_cube


def run(n_frames: int = 20, out_dir=None, device="cuda", seed: int = 0):
    """Returns (the PlaneFit or None, the number of AR frames written)."""
    out_dir = out_dir or os.path.join(tempfile.gettempdir(), "ar_demo")
    os.makedirs(out_dir, exist_ok=True)
    cam = PinholeCamera(fx=350.0, fy=350.0, cx=160.0, cy=120.0, width=320, height=240)
    scene = StepWallScene(np.random.default_rng(11))
    poses = orbit_trajectory(n_frames, step=0.045)
    system = System(cam, SensorType.MONOCULAR, orb=ORBConfig(n_features=400), device=device,
                    max_keyframes=60, max_points=8000, kf_max_frames=10)

    results = {}
    runner = LiveRunner(system, on_result=lambda i, ts, pose: results.__setitem__(ts, pose))
    runner.start()
    frames = {}
    for i, (R, t) in enumerate(poses):
        img = scene.render(cam, R, t)
        frames[float(i)] = img
        runner.push(img, float(i))
        # Lock-step for the demo, so every frame adds to the map; a camera
        # would keep pushing and the runner would drop stale frames.
        while runner.n_tracked + runner.n_dropped < runner.n_pushed:
            time.sleep(0.02)
    runner.stop()
    print(f"pushed={runner.n_pushed} tracked={runner.n_tracked} "
          f"dropped={runner.n_dropped} state={system.state.name}")

    # The plane from well-observed map points (ViewerAR gates at > 5
    # observations; this short demo at 3).
    m = system.tracker.map
    has = (m.kf_obs_pt >= 0) & m.kf_kp_valid & m.kf_valid[:, None]
    obs_cnt = torch.zeros(m.capacity_pt + 1, dtype=torch.int32, device=m.pt_xyz.device)
    obs_cnt.index_add_(0, torch.where(has, m.kf_obs_pt, m.capacity_pt).reshape(-1).long(),
                       has.reshape(-1).to(torch.int32))
    well = (obs_cnt[:-1] >= 3) & m.pt_valid
    R_last, t_last = system.tracker._pose_out()
    plane = detect_plane(m.pt_xyz, well, -R_last.T @ t_last,
                         generator=torch.Generator().manual_seed(seed))
    if not bool(plane.success):
        print("no plane found (need >= 50 well-observed points)")
        return None, 0
    print(f"plane: normal={plane.normal.cpu().numpy().round(3)} inliers={int(plane.inliers.sum())}")

    n_out = 0
    for ts, pose in sorted(results.items()):
        if pose is None:
            continue
        R, t = pose
        draw_ar_cube(frames[ts], cam, R, t, plane, size=0.4).save(f"{out_dir}/ar_{int(ts):04d}.png")
        n_out += 1
    print(f"wrote {n_out} AR frames to {out_dir}")
    return plane, n_out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    run(int(argv[0]) if argv else 20, *argv[1:2])


if __name__ == "__main__":
    main()
