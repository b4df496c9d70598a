"""End-to-end demo on the synthetic renderer (no dataset needed). Port of
examples/run_synthetic.py.

Runs mono, stereo or RGB-D SLAM on a rendered staircase scene
(testing.StepWallScene), prints each frame's state and tracking time and
the final Sim3- (mono) or SE3-aligned ATE, and writes the TUM trajectory.

Usage: python -m tpuslam_torch.examples.run_synthetic [mono|stereo|rgbd] [n_frames] [out.txt]
"""

from __future__ import annotations

import os
import sys
import tempfile
import time

import numpy as np
import torch

from tpuslam_torch.geometry.camera import PinholeCamera
from tpuslam_torch.ops.orb import ORBConfig
from tpuslam_torch.pipeline.system import SensorType, System
from tpuslam_torch.testing import StepWallScene, orbit_trajectory, trajectory_ate

BASELINE = 0.12


def run(mode: str = "mono", n_frames: int = 30, out=None, device="cuda") -> System:
    cam = PinholeCamera(fx=350.0, fy=350.0, cx=160.0, cy=120.0,
                        bf=350.0 * BASELINE if mode != "mono" else 0.0, width=320, height=240)
    scene = StepWallScene(np.random.default_rng(11))
    poses = orbit_trajectory(n_frames, step=0.045)
    sensor = {"mono": SensorType.MONOCULAR, "stereo": SensorType.STEREO, "rgbd": SensorType.RGBD}[mode]
    # init_min_matches scales with the feature budget: the reference's 100
    # assumes 1000 features; this demo runs 400 on a quarter-size image.
    system = System(cam, sensor, orb=ORBConfig(n_features=400), device=device, max_keyframes=60,
                    max_points=8000, kf_max_frames=10, init_min_matches=60)
    dev = system.tracker.device
    times = []
    for i, (R, t) in enumerate(poses):
        t0 = time.perf_counter()
        if mode == "mono":
            system.track_monocular(scene.render(cam, R, t), i / 30.0)
        elif mode == "stereo":
            right = scene.render(cam, R, t - np.array([BASELINE, 0, 0], np.float32))
            system.track_stereo(scene.render(cam, R, t), right, i / 30.0)
        else:
            img, depth = scene.render(cam, R, t, with_depth=True)
            system.track_rgbd(img, depth, i / 30.0)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        times.append(time.perf_counter() - t0)
        print(f"frame {i:3d}: {system.state.name:16s} {times[-1] * 1000:7.1f} ms")

    print(system.map_stats())
    print(f"median frame time: {np.median(times) * 1000:.1f} ms")
    traj = system.tracker.export_trajectory()
    n_ok = sum(1 for *_, lost in traj if not lost)
    if n_ok > 5:
        ate, n, _ = trajectory_ate(traj, poses, fix_scale=mode != "mono")
        print(f"ATE RMSE ({'SE3' if mode != 'mono' else 'Sim3'}-aligned): {ate:.4f} over {n} frames")
    out = out or os.path.join(tempfile.gettempdir(), f"synthetic_{mode}_traj.txt")
    system.save_trajectory_tum(out)
    print(f"trajectory: {out}")
    return system


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    run(argv[0] if argv else "mono", int(argv[1]) if len(argv) > 1 else 30, *argv[2:3])


if __name__ == "__main__":
    main()
