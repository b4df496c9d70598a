"""Stereo KITTI driver (the reference's Examples/Stereo/stereo_kitti.cc).
Port of examples/stereo_kitti.py.

Usage: python -m tpuslam_torch.examples.stereo_kitti <settings.yaml> <sequence_dir> [out.txt]
"""

from __future__ import annotations

import sys

from tpuslam_torch.examples._driver import DriverRun, drive, report
from tpuslam_torch.io import KITTISequence, load_settings
from tpuslam_torch.pipeline.system import SensorType, System


def run(settings, sequence: str, out: str = "CameraTrajectory.txt", device="cuda") -> DriverRun:
    system = System(settings.cam, SensorType.STEREO, orb=settings.orb, device=device,
                    kf_max_frames=int(settings.fps), th_depth_factor=settings.th_depth_factor)
    seq = KITTISequence(sequence)
    res = drive(system, seq, lambda f: system.track_stereo(f[1], f[2], f[0]))
    system.save_trajectory_kitti(out)
    report(res, out)
    return res


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    run(load_settings(argv[0], width=1241, height=376), argv[1], *argv[2:3])


if __name__ == "__main__":
    main()
