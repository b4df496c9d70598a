"""Monocular EuRoC driver (the reference's Examples/Monocular/mono_euroc.cc).
Port of examples/mono_euroc.py.

Usage: python -m tpuslam_torch.examples.mono_euroc <settings.yaml> <mav0_root> [timestamps.txt] [out.txt]
"""

from __future__ import annotations

import sys

from tpuslam_torch.examples._driver import DriverRun, drive, report
from tpuslam_torch.io import EuRoCSequence, load_settings
from tpuslam_torch.pipeline.system import SensorType, System


def run(settings, sequence: str, out: str = "KeyFrameTrajectory.txt", device="cuda",
        timestamps=None) -> DriverRun:
    system = System(settings.cam, SensorType.MONOCULAR, orb=settings.orb, device=device,
                    kf_max_frames=int(settings.fps))
    seq = EuRoCSequence(sequence, timestamps=timestamps, stereo=False)
    res = drive(system, seq, lambda f: system.track_monocular(f[1], f[0]))
    system.save_trajectory_tum(out)
    report(res, out)
    return res


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    out = argv[3] if len(argv) > 3 else "KeyFrameTrajectory.txt"
    run(load_settings(argv[0], width=752, height=480), argv[1], out,
        timestamps=argv[2] if len(argv) > 2 else None)


if __name__ == "__main__":
    main()
