"""Monocular TUM driver (the reference's Examples/Monocular/mono_tum.cc).
Port of examples/mono_tum.py.

Usage: python -m tpuslam_torch.examples.mono_tum <settings.yaml> <sequence_dir> [out.txt]
"""

from __future__ import annotations

import sys

from tpuslam_torch.examples._driver import DriverRun, drive, report
from tpuslam_torch.io import TUMSequence, load_settings
from tpuslam_torch.pipeline.system import SensorType, System


def run(settings, sequence: str, out: str = "KeyFrameTrajectory.txt", device="cuda") -> DriverRun:
    system = System(settings.cam, SensorType.MONOCULAR, orb=settings.orb, device=device,
                    kf_max_frames=int(settings.fps), th_depth_factor=settings.th_depth_factor)
    seq = TUMSequence(sequence)
    res = drive(system, seq, lambda f: system.track_monocular(f[1], f[0]))
    system.save_trajectory_tum(out)
    report(res, out)
    return res


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    run(load_settings(argv[0]), argv[1], *argv[2:3])


if __name__ == "__main__":
    main()
