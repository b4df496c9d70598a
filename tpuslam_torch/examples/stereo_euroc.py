"""Stereo EuRoC driver with online rectification (the reference's
Examples/Stereo/stereo_euroc.cc with its initUndistortRectifyMap and remap
preprocessing). Port of examples/stereo_euroc.py: each pair is rectified on
the tracker's device.

Usage: python -m tpuslam_torch.examples.stereo_euroc <EuRoC.yaml> <mav0_root> [timestamps.txt] [out.txt]
"""

from __future__ import annotations

import sys

from tpuslam_torch.examples._driver import DriverRun, drive, report
from tpuslam_torch.io import EuRoCSequence, load_settings
from tpuslam_torch.io.rectify import StereoRectifier
from tpuslam_torch.pipeline.system import SensorType, System


def run(settings, sequence: str, out: str = "CameraTrajectory.txt", device="cuda",
        timestamps=None) -> DriverRun:
    if settings.left_rect is None:
        raise ValueError("settings lack the LEFT./RIGHT. rectification blocks")
    cam = settings.cam
    rect = StereoRectifier(settings.left_rect, settings.right_rect, cam.width, cam.height,
                           device=device)
    system = System(cam, SensorType.STEREO, orb=settings.orb, device=device,
                    kf_max_frames=int(settings.fps), th_depth_factor=settings.th_depth_factor)
    seq = EuRoCSequence(sequence, timestamps=timestamps, stereo=True)
    res = drive(system, seq, lambda f: system.track_stereo(*rect(f[1], f[2]), f[0]))
    system.save_trajectory_tum(out)
    report(res, out)
    return res


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    out = argv[3] if len(argv) > 3 else "CameraTrajectory.txt"
    run(load_settings(argv[0], width=752, height=480), argv[1], out,
        timestamps=argv[2] if len(argv) > 2 else None)


if __name__ == "__main__":
    main()
